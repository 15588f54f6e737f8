"""p99 of the host's time between two decode launches: from the end of one
``serve.decode_iter`` span to the start of the next (admission, prefills,
scheduling), leaving out gaps in which the engine was idle waiting for an
arrival.  Read on the window before the traced slice opens, since the
profiler slows the host's dispatch."""
from bench import stats


def read(run):
    w = run.window
    end = run.slice_open or w.t_close
    spans = sorted((a, b) for n, a, b in run.spans
                   if n == "serve.decode_iter" and a >= w.t_open and b <= end)
    gaps = []
    for (a0, b0), (a1, b1) in zip(spans, spans[1:]):
        if any(b0 <= s < a1 for s, _ in w.sleeps):
            continue
        gaps.append(a1 - b0)
    if not gaps:
        return None
    return 1e3 * stats.percentile(gaps, 99)
