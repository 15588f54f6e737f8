"""The flash kernel's calls in the traced slice (whole-prompt prefills):
their least times by the frozen ``flash_attention_cost`` at each call's
shape, over their device time."""
from bench.readings import kernel_roofline


def read(run):
    return kernel_roofline(run, "flash_attention")
