"""p95 over the attempted requests due before the traced slice opened (the
profiler slows the host inside it) of their admission less the time they
were due (tickets' ``t_admit``); never admitted counts as infinite."""
from bench import stats


def read(run):
    end = run.slice_open or run.window.t_close
    reqs = [r for r in stats.attempted(run.window, run.offline)
            if r.due < end]
    if not reqs:
        return None
    return 1e3 * stats.percentile([stats.queue_wait_s(r) for r in reqs], 95)
