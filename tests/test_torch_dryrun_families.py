"""The port's dry-run (``repro_torch.launch.dryrun``) on every model family:
one smoke-size arch a family, each of train, prefill and decode, recorded on
a fake 2 x 4 mesh.

A file of its own, so that a worker runs it beside ``test_torch_dryrun.py``;
a module fixture destroys the fake group after its tests, so that no other
test file that the worker runs next finds a group running.
"""
import pytest

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun

#: one arch a family: dense, MoE, SSM, hybrid, audio, VLM
FAMILY_ARCHS = ("gemma-2b", "qwen2-moe-a2.7b", "mamba2-780m",
                "jamba-v0.1-52b", "whisper-medium", "llava-next-34b")


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    dryrun.release_fake_mesh()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_cell_records(arch, kind):
    """The cell records rank 0's program: compute and collectives."""
    cfg = SMOKE_ARCHS[arch]
    assert cfg.family in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
    rec = dryrun.dry_cell(cfg, ShapeConfig(kind, 64, 8, kind),
                          dryrun.fake_mesh(sizes=(2, 4)), f"{arch}:{kind}",
                          {}, keep_artifacts=True)
    cs = rec.pop("_captured")
    assert rec["status"] == "ok"
    assert cs.flops > 0 and cs.collective_link_bytes > 0
    assert rec["roofline"]["compute_s"] > 0
    assert not cs.stream.unknown_trip_counts
