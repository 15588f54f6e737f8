"""The RMSNorm kernel's calls in the traced slice (prefill and decode
graphs): their least times by the frozen ``rms_norm_cost`` at each call's
shape, over their device time."""
from bench.readings import kernel_roofline


def read(run):
    return kernel_roofline(run, "rms_norm")
