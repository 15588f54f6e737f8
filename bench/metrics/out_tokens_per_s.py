"""Output tokens harvested in the window over its length: every step that
ended inside it, and the share of the step in flight at the close that
lies inside (``bench/stats.py::window_work``)."""
from bench import stats


def read(run):
    return stats.window_work(run.window) / run.window.seconds
