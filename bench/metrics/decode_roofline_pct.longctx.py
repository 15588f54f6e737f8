"""The bytes the slice's decode launches need (the weights once a step,
each request's K/V at its current length, counted from the tickets and the
shapes by ``bench/costs``) over the HBM peak, over their device time."""
from bench.readings import decode_bytes, decode_launches


def read(run):
    got = decode_launches(run)
    took = sum(s for s, _ in got)
    if took <= 0:
        return None
    need = sum(decode_bytes(run, step) for _, step in got)
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / took
