"""Process start to the window's opening: imports, CUDA, the weights, the
engine and its decode graph, the mix's prefill graphs."""


def read(run):
    return run.setup_s
