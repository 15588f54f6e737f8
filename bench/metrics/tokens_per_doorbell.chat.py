"""Output tokens over the engine's doorbells (``engine.tracker`` count),
both counted over the steps that ended inside the window."""
from bench import stats


def read(run):
    n = stats.window_doorbells(run.window)
    return stats.window_tokens(run.window) / n if n else None
