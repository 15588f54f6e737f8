"""p95 over every attempted request of its first harvested token less the
time it was due; a request that never gave one counts as infinite."""
from bench import stats


def read(run):
    reqs = stats.attempted(run.window, run.offline)
    if not reqs:
        return None
    return 1e3 * stats.percentile([stats.ttft_s(r) for r in reqs], 95)
