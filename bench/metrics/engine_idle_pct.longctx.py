"""Share of the stretch the launch records cover (the window's open to
the traced slice's, or to the close), less the engine's waits for
arrivals, in which no engine launch was on the device: the union of the
launches' device intervals (tickets' ``launches``) against that time."""


def launches(run):
    """The engine's launch records (a record that riders share, once),
    read on the device, of the launches enqueued after the window opened
    and before the traced slice opened (the close, without a slice): the
    profiler slows the host's dispatch.  Empty on a program without them."""
    w = run.window
    end = run.slice_open or w.t_close
    got = {id(x): x for r in w.reqs for x in getattr(r.ticket, "launches", ())
           if w.t_open <= x.t_enqueue < end and x.t_end >= 0}
    return sorted(got.values(), key=lambda x: x.t_enqueue)


def read(run):
    got = launches(run)
    if not got:
        return None
    w = run.window
    lo, hi = w.t_open, run.slice_open or w.t_close
    waits = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in w.sleeps)
    busy, reached = 0.0, lo
    for x in sorted(got, key=lambda x: x.t_start):
        a, b = max(x.t_start, reached), min(x.t_end, hi)
        if b > a:
            busy += b - a
        reached = max(reached, b)
    return 100.0 * (1.0 - busy / (hi - lo - waits))
