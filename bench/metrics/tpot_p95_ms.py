"""p95 over every attempted request of (done - first token) / (tokens - 1);
a request that did not finish counts as infinite."""
from bench import stats


def read(run):
    reqs = stats.attempted(run.window, run.offline)
    if not reqs:
        return None
    return 1e3 * stats.percentile([stats.tpot_s(r) for r in reqs], 95)
