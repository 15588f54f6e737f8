"""The pipeline decode on the card: ``PPDecoder``'s launch on a one-rank
NCCL mesh against the port's sequential ``decode_step``.  Marked ``cuda``:
it skips without a card.  The file imports no JAX, so it runs on the
card's machine too:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.distributed.pp_decode import PPDecoder
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import TransformerLM


@pytest.mark.cuda
def test_pp_decoder_matches_sequential_on_one_rank_nccl(tmp_path):
    """The PP launch at T=2 (one-rank NCCL mesh) against two sequential
    ``decode_step`` calls on the same weights and state, fp32, 3 launches:
    logits, then the caches and the length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL has no CPU mode")
    cfg = dataclasses.replace(SMOKE_ARCHS["gemma-2b"], param_dtype="float32",
                              head_dim=64)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device="cuda")
        lm = TransformerLM(cfg, device="cuda")
        params = lm.init_params(0)
        B, S, T = 4, 32, 2
        seq = lm.init_decode_state(B, S)
        pp = PPDecoder(cfg, mesh, tokens_per_launch=T)
        pst = pp.state_from_lm({k: v.clone() for k, v in seq.items()})
        launch = pp.make_local_step(B, S)
        lp = pp.shard_params(pp.params_from_lm(params))
        ls = pp.shard_state(pst)
        g = torch.Generator(device="cuda").manual_seed(1)
        for _ in range(3):
            toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                                 device="cuda", dtype=torch.int32)
            want = torch.cat([lm.decode_step(params, seq, toks[:, j:j + 1])[1]
                              for j in range(T)], dim=1)
            got = launch(lp, ls, toks)
            torch.testing.assert_close(got[..., :want.shape[-1]],
                                       want.float(), rtol=1e-3, atol=1e-3)
        for key in ("k", "v"):
            torch.testing.assert_close(ls[key][0], seq[key], rtol=1e-4,
                                       atol=1e-4)
        assert int(ls["length"]) == int(seq["length"]) == 3 * T
    finally:
        dist.destroy_process_group()
