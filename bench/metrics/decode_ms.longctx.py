"""Device time of the kernels under one decode graph launch (T steps over
every slot), mean over the launches in the traced slice."""
from bench.readings import decode_launches


def read(run):
    got = decode_launches(run)
    if not got:
        return None
    return 1e3 * sum(s for s, _ in got) / len(got)
