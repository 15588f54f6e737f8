"""The port's sharding rules against the reference's.

For all ten architectures, on both production layouts and on a 2 x 2
layout, the port's ``ShardingRules`` (over ``MeshLayout`` and the port's own
trees: ``param_specs`` Spec trees, decode states built on the ``meta``
device, ``make_input_specs``' meta batches) give the reference's specs
(over ``jax.eval_shape`` trees and ``tests/test_sharding.py``'s duck-typed
mesh) leaf for leaf, and the same ``dropped`` list: params, optimizer state
with ZeRO-1 on and off and fsdp on and off, the decode_32k and long_500k
states, and every shape's batch.  ``resolve`` equals the reference's field
for field.  The nine cases of ``tests/test_sharding.py`` run on the port
under their names.
"""
import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import resolve as ref_resolve
from repro.distributed import sharding as ref_sh
from repro.models import get_model as ref_get_model
from repro.runtime.steps import make_input_specs as ref_input_specs

from repro_torch.configs import ARCHS, SHAPES, resolve
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import P, PartitionSpec
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models import get_model, param_specs
from repro_torch.runtime.steps import make_input_specs


class FakeMesh:
    """Duck-typed mesh: axis_names + shape dict (no devices touched)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


LAYOUTS = {"single": MeshLayout.production(False),
           "multi": MeshLayout.production(True),
           "2x2": MeshLayout.of(2, 2)}
MESH = LAYOUTS["single"]
MESH_MP = LAYOUTS["multi"]
DECODE_SHAPES = ("decode_32k", "long_500k")


def _rules(arch, mesh=MESH, **kw):
    cfg = resolve(ARCHS[arch], model_axis=mesh.shape["model"])
    return sh.ShardingRules(mesh, cfg, **kw), cfg


# ---------------------------------------------------------------- trees
@functools.lru_cache(maxsize=None)
def _ref_trees(arch: str, model_axis: int):
    cfg = ref_resolve(REF_ARCHS[arch], model_axis=model_axis)
    model = ref_get_model(cfg)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    states = {s: jax.eval_shape(lambda s=s: model.init_decode_state(
        REF_SHAPES[s].global_batch, REF_SHAPES[s].seq_len))
        for s in DECODE_SHAPES}
    batches = {s: ref_input_specs(cfg, REF_SHAPES[s]) for s in REF_SHAPES}
    return cfg, params, states, batches


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str, model_axis: int):
    cfg = resolve(ARCHS[arch], model_axis=model_axis)
    model = get_model(cfg, device="cpu")
    model.device = torch.device("meta")        # shapes only
    states = {s: model.init_decode_state(SHAPES[s].global_batch,
                                         SHAPES[s].seq_len)
              for s in DECODE_SHAPES}
    batches = {s: make_input_specs(cfg, SHAPES[s]) for s in SHAPES}
    return cfg, param_specs(cfg), states, batches


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {ref_sh._path_str(p): tuple(s) for p, s in leaves}


def _flat_port(tree, prefix=""):
    if isinstance(tree, PartitionSpec):
        return {prefix[:-1]: tuple(tree)}
    return {k: v for key in tree
            for k, v in _flat_port(tree[key], f"{prefix}{key}/").items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_match_the_reference(arch, layout):
    """Params, optimizer state (ZeRO-1 on/off x fsdp on/off), decode
    states and batches: the same specs and the same ``dropped`` list."""
    mesh = LAYOUTS[layout]
    fake = FakeMesh(mesh.shape)
    rcfg, rparams, rstates, rbatches = _ref_trees(arch, mesh.shape["model"])
    cfg, params, states, batches = _port_trees(arch, mesh.shape["model"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    for fsdp in (False, True):
        for zero1 in (True, False):
            r = ref_sh.ShardingRules(fake, dataclasses.replace(rcfg,
                                                               fsdp=fsdp),
                                     zero1=zero1)
            p = sh.ShardingRules(mesh, dataclasses.replace(cfg, fsdp=fsdp),
                                 zero1=zero1)
            assert _flat_port(p.param_specs(params)) == \
                _flat_ref(r.param_specs(rparams))
            assert _flat_port(p.opt_specs(params)) == \
                _flat_ref(r.opt_specs(rparams))
            for s in DECODE_SHAPES:
                assert _flat_port(p.state_specs(states[s])) == \
                    _flat_ref(r.state_specs(rstates[s])), s
            for s in SHAPES:
                assert _flat_port(p.data_specs(batches[s])) == \
                    _flat_ref(r.data_specs(rbatches[s])), s
            assert p.dropped == r.dropped
            assert p.batch_spec(1) == r.batch_spec(1)
            assert p.dropped == r.dropped


@pytest.mark.parametrize("model_axis", [1, 4, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolve_matches_the_reference(arch, model_axis):
    assert dataclasses.asdict(resolve(ARCHS[arch], model_axis)) == \
        dataclasses.asdict(ref_resolve(REF_ARCHS[arch], model_axis))


# ------------------------------------------- tests/test_sharding.py's cases
def test_attention_tp_specs():
    rules, cfg = _rules("deepseek-7b")
    assert rules.param_spec("layers/attn/wq", (30, 4096, 32, 128)) == \
        P(None, None, "model", None)
    assert rules.param_spec("layers/attn/wo", (30, 32, 128, 4096)) == \
        P(None, "model", None, None)
    assert rules.param_spec("layers/mlp/w_gate", (30, 4096, 11008)) == \
        P(None, None, "model")
    assert rules.param_spec("emb/embed", (102400, 4096)) == P("model", None)


def test_kv_heads_replicated_when_indivisible():
    rules, cfg = _rules("llama3-405b")  # kv=8 on 16-way model axis
    spec = rules.param_spec("layers/attn/wk", (126, 16384, 8, 128))
    assert spec[2] is None  # kv-head dim must NOT be model-sharded
    assert spec == P(None, ("data",), None, None)
    assert len(rules.dropped) >= 1


def test_fsdp_adds_dp_axis():
    rules, cfg = _rules("llama3-405b")
    assert cfg.fsdp
    spec = rules.param_spec("layers/mlp/w_gate", (126, 16384, 53248))
    assert spec == P(None, ("data",), "model")
    rules_mp, _ = _rules("llama3-405b", mesh=MESH_MP)
    spec = rules_mp.param_spec("layers/mlp/w_gate", (126, 16384, 53248))
    assert spec == P(None, ("pod", "data"), "model")


def test_zero1_opt_state_sharded_over_dp():
    rules, cfg = _rules("deepseek-7b")  # fsdp off -> ZeRO-1 adds dp
    spec = rules.opt_spec("m/layers/mlp/w_gate", (30, 4096, 11008))
    flat = [a for ax in spec for a in (ax if isinstance(ax, tuple) else (ax,))]
    assert "data" in flat and "model" in flat


def test_norms_replicated():
    rules, _ = _rules("qwen3-8b")
    assert rules.param_spec("layers/ln1/scale", (36, 4096)) == P()


def test_vocab_and_head_padding():
    cfg = resolve(ARCHS["whisper-medium"], 16)
    assert cfg.vocab_padded % 16 == 0 and cfg.vocab_padded >= 51865
    cfg = resolve(ARCHS["llava-next-34b"], 16)
    assert cfg.n_heads_padded == 64
    cfg = resolve(ARCHS["mamba2-780m"], 16)
    assert cfg.vocab_padded % 16 == 0
    # already-divisible archs stay exact
    cfg = resolve(ARCHS["gemma-2b"], 16)
    assert cfg.vocab_padded == 256000


def test_batch_spec_fallback_batch1():
    rules, _ = _rules("jamba-v0.1-52b")
    assert rules.batch_spec(256) == "data"
    assert rules.batch_spec(1) is None  # long_500k: replicate batch


def test_kv_cache_seq_sharding_when_heads_indivisible():
    rules, _ = _rules("llama3-405b")
    # [L, B, S, Hkv, hd] with kv=8 (indivisible): sequence gets 'model'
    spec = rules.state_spec("k", (126, 128, 32768, 8, 128))
    assert spec[2] == "model" and spec[3] is None
    assert spec[1] == "data"
    # batch=1 long-context: seq picks up data too
    spec1 = rules.state_spec("k", (4, 1, 1, 524288, 8, 128))
    assert spec1[3] == ("data", "model")


def test_moe_expert_internal_tp():
    rules, _ = _rules("grok-1-314b")
    spec = rules.param_spec("layers/moe/w_gate", (64, 8, 6144, 32768))
    assert spec[-1] == "model"
    assert spec[1] is None  # experts replicated in baseline


def test_one_rank_layout_replicates_everything():
    """On a (1, 1) layout every rule resolves to full replication and
    nothing is dropped, for every architecture."""
    layout = MeshLayout.of(1, 1)
    for arch in ARCHS:
        rules = sh.ShardingRules(layout, resolve(ARCHS[arch], 1))
        specs = _flat_port(rules.param_specs(param_specs(rules.cfg)))
        assert all(a is None for s in specs.values() for a in s), arch
        assert rules.dropped == []


def test_to_placements_orders_tuple_axes_by_mesh_dim():
    """A tuple axis shards one dim over several mesh dims, in mesh order;
    the other order has no DTensor placement and raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshLayout.production(True)
    assert sh.to_placements(P(("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert sh.to_placements(P(None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh's order"):
        sh.to_placements(P(("data", "pod")), mesh)
