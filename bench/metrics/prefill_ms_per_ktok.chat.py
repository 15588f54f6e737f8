"""Device time of the engine's prefill and extend launches over the
prompt tokens they pushed, in ms a thousand tokens (1e6 x seconds over
tokens), from the program's own launch records (tickets' ``launches``)."""


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
    pre = [x for x in launches(run) if not x.decode]
    tokens = sum(x.tokens for x in pre)
    if not tokens:
        return None
    return 1e6 * sum(x.device_s for x in pre) / tokens
