"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

The port records each cell's rank-0 program as DTensors over a fake
process group.  The fake group lives in this process: a module fixture
destroys it after the file's tests, so that no other test file that a
worker runs next finds a group running.  The reference's lowering needs 8
forced host devices, so its side of the FLOPs comparison runs in a child
process, as ``tests/test_multidevice.py`` does.
"""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import resolve as ref_resolve
from repro.configs import skip_reason as ref_skip_reason

from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.stream import recorded_call
from repro_torch.launch import dryrun

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMOKE_TRAIN = ShapeConfig("t", 64, 8, "train")


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    dryrun.release_fake_mesh()


# ---------------------------------------------------------------- (1)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skips_equal_the_reference(arch):
    """Every shape on both meshes: the same skip and reason (config
    only: a skipped cell returns before any mesh is built)."""
    for multi in (False, True):
        for shape in REF_SHAPES:
            want = ref_skip_reason(ref_resolve(REF_ARCHS[arch],
                                               model_axis=16),
                                   REF_SHAPES[shape])
            assert dryrun.cell_skip(arch, shape, multi) == want
            if want:
                rec = dryrun.run_cell(arch, shape, multi)
                assert (rec["status"], rec["reason"]) == ("skip", want)
                assert rec["chips"] == (512 if multi else 256)


# ---------------------------------------------------------------- (2)
def _reference_record_keys():
    """The keys the reference's ``run_cell`` gives an ``ok`` record, read
    from its source: the first record literal and ``rec.update``'s."""
    tree = ast.parse(open(os.path.join(ROOT, "src/repro/launch/dryrun.py"))
                     .read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "status"
                and isinstance(v, ast.Constant) and v.value == "ok"
                for k, v in zip(node.keys, node.values)):
            keys |= {k.value for k in node.keys}
        if (isinstance(node, ast.AnnAssign) and isinstance(node.value,
                                                            ast.Dict)):
            keys |= {k.value for k in node.value.keys}
    return keys


def test_record_keys_and_dropped_equal_the_reference():
    """gemma-2b x decode_32k x single: the reference's record keys, and
    its ``dropped_shardings``: the reference's ``ShardingRules.dropped`` on
    the same layout after the param, state and batch specs its
    ``run_cell`` takes, in that order."""
    import jax
    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.models import get_model as ref_get_model
    from repro.runtime.steps import make_input_specs as ref_input_specs
    from test_torch_sharding import FakeMesh

    rec = dryrun.run_cell("gemma-2b", "decode_32k", False)
    assert rec["status"] == "ok"
    # the port adds one key: the ops run on replicated operands
    assert set(rec) == _reference_record_keys() | {"replicated_ops"}
    cfg = ref_resolve(REF_ARCHS["gemma-2b"], model_axis=16)
    model = ref_get_model(cfg)
    shape = REF_SHAPES["decode_32k"]
    rules = RefRules(FakeMesh({"data": 16, "model": 16}), cfg)
    rules.param_specs(jax.eval_shape(
        lambda: model.init_params(jax.random.PRNGKey(0))))
    rules.state_specs(jax.eval_shape(
        lambda: model.init_decode_state(shape.global_batch, shape.seq_len)))
    rules.data_specs(ref_input_specs(cfg, shape))
    assert rules.dropped, "a cell that drops nothing shows nothing"
    assert rec["dropped_shardings"] == rules.dropped[:20]


# ---------------------------------------------------------------- (3), (5)
@pytest.fixture(scope="module")
def smoke_cell():
    """qwen3-smoke's train step on a fake 2 x 4 mesh, recorded once."""
    return dryrun.dry_cell(SMOKE_ARCHS["qwen3-8b"], SMOKE_TRAIN,
                           dryrun.fake_mesh(sizes=(2, 4)), "t", {},
                           keep_artifacts=True)


def test_dryrun_smoke_cell_records(smoke_cell):
    """``tests/test_multidevice.py::test_dryrun_smoke_cell_compiles`` on
    the port."""
    cs = smoke_cell["_captured"]
    assert cs.flops > 0 and cs.collective_link_bytes > 0
    assert not cs.stream.unknown_trip_counts


#: the port's compute-engine FLOPs over the reference's dot FLOPs, per
#: device.  DTensor picks each op's sharding by its own cost model, GSPMD
#: by propagation over the whole program: at smoke widths DTensor gathers
#: the small MLP weights and runs the MLP products whole over the model
#: axis, where GSPMD splits them (measured: 1.15x); a wider gap means a
#: product charged at its global shape or a sharding lost
FLOPS_TOL = 0.25


def test_smoke_cell_flops_near_the_reference(smoke_cell):
    code = """
        import jax
        from repro.configs import SMOKE_ARCHS
        from repro.configs.shapes import ShapeConfig
        from repro.models import get_model
        from repro.runtime.steps import make_train_step, init_all, make_input_specs
        from repro.distributed.sharding import ShardingRules
        from repro.launch.mesh import make_mesh
        from repro.core import CommandStreamCapture
        cfg = SMOKE_ARCHS["qwen3-8b"]
        model = get_model(cfg)
        mesh = make_mesh(2, 4)
        rules = ShardingRules(mesh, cfg)
        batch = make_input_specs(cfg, ShapeConfig("t", 64, 8, "train"))
        params_s, opt_s = jax.eval_shape(lambda: init_all(model, cfg))
        with mesh:
            cs = CommandStreamCapture().lower_and_compile(
                "t", make_train_step(model, cfg),
                args=(params_s, opt_s, batch),
                in_shardings=(rules.to_shardings(rules.param_specs(params_s)),
                              rules.to_shardings(rules.opt_specs(opt_s)),
                              rules.to_shardings(rules.data_specs(batch))))
        print(sum(e.flops * e.multiplier for e in cs.stream.entries
                  if e.engine == "compute"), *cfg.param_counts())
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref_flops, ref_total, ref_active = map(int, out.stdout.split()[-3:])
    rec = smoke_cell
    flops = sum(e.flops for e in rec["_captured"].stream.entries
                if e.engine == "compute")
    assert abs(flops / ref_flops - 1) <= FLOPS_TOL, (flops, ref_flops)
    assert (rec["model_params_total"], rec["model_params_active"]) == (
        ref_total, ref_active)


# ---------------------------------------------------------------- (4)
def test_sharded_matmul_charges_rank_0s_work():
    """Global [64, 64] @ [64, 32] on 16 x 16: x split by rows over data,
    w by rows over model.  Rank 0 multiplies [4, 4] by [4, 32]: one mm of
    1024 FLOPs and 576 operand bytes, no entry at a global shape, and one
    all-reduce of its 512 B partial over the 16 ranks of its model group,
    2 * 512 * 15 / 16 = 960 link bytes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dryrun.fake_mesh()
    x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4, 32, device="meta"), mesh,
                           [Replicate(), Shard(0)], run_check=False)
    out, st, _ = recorded_call(
        lambda: (x @ w).redistribute(mesh, [Shard(0), Replicate()]))
    assert tuple(out.to_local().shape) == (4, 32)
    mms = [e for e in st.entries if e.engine == "compute"]
    assert [(e.opcode, e.flops, e.operand_bytes) for e in mms] == [
        ("mm", 1024, 576)]
    assert not [e for e in st.entries
                if "[64, 64]" in e.raw or "[64, 32]" in e.raw]
    col = st.collective_entries
    assert [(e.opcode, e.operand_bytes, e.group_size, e.link_bytes)
            for e in col] == [("all-reduce", 512, 16, 960)]
    assert st.collective_link_bytes == 960


# ---------------------------------------------------------------- (6)
def test_pp_cell_records_its_hops():
    """One PP launch of llama3-smoke on a fake 2 x 4 mesh (2 stages): the
    reference's PP keys and at least one collective-permute."""
    rec = dryrun.dry_pp_cell(SMOKE_ARCHS["llama3-405b"],
                             ShapeConfig("d", 64, 8, "decode"),
                             dryrun.fake_mesh(sizes=(2, 4)), "pp", {},
                             tokens_per_launch=2)
    assert rec["pp"] is True and rec["tokens_per_launch"] == 2
    counts = rec["stream"]["collective_counts"]
    assert counts.get("collective-permute", 0) >= 1, counts
    assert rec["roofline"]["collective_s"] > 0


# ---------------------------------------------------------------- handlers
def _dtensor_on(mesh, shape, placements):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(
        torch.empty(local, device="meta"), mesh, placements, run_check=False,
        shape=torch.Size(shape), stride=torch.empty(shape,
                                                    device="meta").stride())


@pytest.mark.parametrize("placements,dims", [("S0 S2", [1]),
                                             ("S0 S1", [1])])
def test_flip_equals_dtensors_own(placements, dims):
    """The dry-run's ``flip`` (which the card's torch cannot shard) gives
    DTensor's own placements and local block on this torch."""
    from torch.distributed.tensor import Shard
    pl = [Shard(int(p[1:])) for p in placements.split()]
    x = _dtensor_on(dryrun.fake_mesh(sizes=(2, 4)), (8, 16, 8), pl)
    mine = dryrun._flip(torch.ops.aten.flip.default, (x, dims), {})
    theirs = torch.ops.aten.flip.default(x, dims)
    assert mine.placements == theirs.placements
    assert mine.to_local().shape == theirs.to_local().shape
