"""The hybrid's decode as one CUDA Graph on the card: ``HybridLM.decode_step``
captured through ``core/graphs.py::CapturedStep`` and replayed 8 times,
each replay's logits and state held to an eager ``decode_step`` from the
same state (jamba's smoke layout at d 256, 4 heads of 64, fp32;
``chip_smoke.hybrid_replays``, which phase Z4 runs too).  A capture of the
hybrid's decode was once invalidated at the first Mamba2 decode einsum.
Marked ``cuda``: it skips without a card.  The file imports no JAX, so it
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hybrid_cuda.py
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.cuda
def test_hybrid_decode_graph_replays_equal_eager_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode is captured as a CUDA "
                    "Graph")
    import chip_smoke
    worst = chip_smoke.hybrid_replays(torch.device("cuda"), replays=8)
    assert worst["logits"] <= chip_smoke.Z_HYBRID["tol"]
    assert worst["state"] <= chip_smoke.Z_HYBRID["tol"]
