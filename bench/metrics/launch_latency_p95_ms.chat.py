"""p95 (nearest rank) over every engine launch of its device start less
the host's reading just before the graph's ``replay()``, from the
program's own launch records (tickets' ``launches``)."""
from bench import stats


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
    return 1e3 * stats.percentile([x.launch_latency_s for x in got], 95)
