"""Share of the traced slice's wall time in which no operation ran on the
device."""


def read(run):
    tr = run.traced
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
