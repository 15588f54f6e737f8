"""Model FLOPs of the work in the traced slice (2 x active parameters a
token plus attention at each position, for the decode tokens kept and the
prompts prefilled) over the slice's length times the bf16 peak."""
from bench.readings import decode_flops, decode_launches, prefill_launches


def read(run):
    tr = run.traced
    if tr is None or not tr.matched or tr.window_s <= 0:
        return None
    flops = sum(decode_flops(run, step) for _, step in decode_launches(run))
    flops += sum(run.shapes.prefill_flops(S)
                 for _, S in prefill_launches(run))
    if flops <= 0:
        return None
    return 100.0 * flops / (tr.window_s * run.peaks["bf16_flops"])
