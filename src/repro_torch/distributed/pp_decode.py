"""Pipeline-parallel decode for dense LMs (per-rank shard_map: PP x TP x
SP-KV), the port of ``repro.distributed.pp_decode``.

The FSDP decode baseline must all-gather every weight shard once per token
(47 GB/device/token for llama3-405b, the dominant collective term of the
decode_32k cell).  Pipelining layers over the 'data' axis makes the weights
STATIONARY: each stage holds L/n_stages layers TP-sharded over 'model', and
activations [µb, T, D] hop stage -> stage by a ``ppermute``.

The schedule is the *steady-state circular* pipeline: one launch = n_stages
ticks; tick t has stage s serving microbatch (t - s) mod n_µb, so every
stage is busy every tick.  Microbatches with t < s still carry the PREVIOUS
launch's segment (pipeline lag = n_stages - 1 ticks): the activation wire
and the per-µb position offset are part of the decode state, and logits
emerge with that lag, as in a production decode pipeline.

Inside a stage everything is manual TP over 'model':
  * Q heads sharded; KV heads replicated, each rank's Q-head block maps to
    one KV group (requires (H/hk) % (H/tp) == 0 or the converse);
  * KV cache sequence-sharded over 'model'; the new token's K/V row is
    written only by the shard owning its position (a masked in-place
    write: every other shard rewrites its own row unchanged, so no rank
    branches on a device value);
  * attention is flash-decoding: q gathered over 'model', partial softmax
    over the owned sequence slice, combined with pmax/psum over 'model';
  * o-proj / MLP down-proj produce partials -> psum over 'model';
  * embed/unembed are vocab-sharded: masked local lookup + psum.

Every rank runs its own code, so ``axis_index`` is a Python int and the
reference's ``lax.scan``/``fori_loop`` are Python loops.  The numerics are
the port's: ``layers.rms_norm`` (the RMSNorm kernel on the card), ``rotary``
/ ``apply_rope``, ``layers.mlp`` and ``layers.unembed``.  Attention scores
are computed per KV group by a batched product on the cache slice in place
(the cache is never permuted or cast), in the cache's type, then softmaxed
in fp32, as the port's sequential ``decode_attention`` does.

:meth:`PPDecoder.make_local_step` is the launch: it takes this rank's
blocks (:meth:`~PPDecoder.shard_params`, :meth:`~PPDecoder.shard_state`,
cut once), updates the local state in place and returns the local logits
[B, T, V/tp]; positions stay on the device (no ``.item()``), so a launch
can be captured in a CUDA Graph, and it moves no weight bytes.
:meth:`PPDecoder.make_step` wraps it global-in / global-out, as the
reference's ``step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..configs.base import ModelConfig
from ..models.layers import (Params, Spec, apply_rope, dtype_of,
                             embedding_specs, init_from_specs, map_params,
                             mlp, rms_norm, rotary, unembed)
from .context import (P, all_gather, axis_env, axis_index, local_shard,
                      map_specs, mesh_shape, pmax, ppermute, psum, shard_map)

__all__ = ["PPDecoder", "pp_param_specs"]

NEG = float(torch.finfo(torch.float32).min)


def pp_param_specs(cfg: ModelConfig, n_stages: int, layers_per_stage: int
                   ) -> Params:
    """The PP param tree as :class:`Spec` leaves: the embedding, every
    per-layer leaf as [n_stages, layers_per_stage, ...], the final norm,
    and ``valid`` (bool [n_stages, layers_per_stage]: False on the virtual
    layers that pad the stack)."""
    from ..models.transformer import param_specs
    n_virtual = n_stages * layers_per_stage
    lm = param_specs(dataclasses.replace(cfg, n_layers=n_virtual))
    layers = map_params(lambda s: s._replace(
        shape=(n_stages, layers_per_stage) + s.shape[1:]), lm["layers"])
    return {"emb": embedding_specs(cfg), "layers": layers,
            "final_norm": lm["final_norm"],
            "valid": Spec((n_stages, layers_per_stage), 0.0,
                          dtype=torch.bool)}


@dataclasses.dataclass
class PPDecoder:
    """The steady-state pipeline decode step for a dense LM on a mesh.

    ``mesh`` is a ``DeviceMesh`` (the step and the init run on it, on its
    device type) or a ``MeshLayout`` (specs and the LM conversions only)."""

    cfg: ModelConfig
    mesh: Any
    stage_axis: str = "data"
    tp_axis: str = "model"
    tokens_per_launch: int = 1   # T: tokens scored per launch

    def __post_init__(self) -> None:
        cfg = self.cfg
        if cfg.family not in ("dense", "vlm"):
            raise ValueError(f"{cfg.name}: PP decode targets dense LMs, not "
                             f"the {cfg.family!r} family")
        shape = mesh_shape(self.mesh)
        self.n_stages = int(shape[self.stage_axis])
        self.tp = int(shape[self.tp_axis])
        self.layers_per_stage = -(-cfg.n_layers // self.n_stages)
        self.n_virtual = self.layers_per_stage * self.n_stages
        h_loc = cfg.n_heads_padded // self.tp
        n_rep = cfg.n_heads_padded // cfg.n_kv_heads
        if not (n_rep % h_loc == 0 or h_loc % n_rep == 0):
            raise ValueError(f"{cfg.name}: the local Q-head block ({h_loc} "
                             f"heads) must map to one KV group ({n_rep} "
                             f"heads)")

    def _device(self) -> torch.device:
        if not hasattr(self.mesh, "device_type"):
            raise TypeError("a PPDecoder on a MeshLayout gives specs only: "
                            "init_params and init_state need a DeviceMesh")
        return torch.device(self.mesh.device_type)

    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> Params:
        """Seeded random weights in the PP layout (other numbers than the
        reference's generator draws); ``valid`` marks the real layers."""
        dev = self._device()
        specs = pp_param_specs(self.cfg, self.n_stages,
                               self.layers_per_stage)
        valid = specs.pop("valid")
        params = init_from_specs(specs, dtype_of(self.cfg), dev, seed)
        params["valid"] = (torch.arange(self.n_virtual, device=dev)
                           < self.cfg.n_layers).reshape(valid.shape)
        return params

    def init_state(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dev, dtype = self._device(), dtype_of(cfg)
        shape = (self.n_stages, self.layers_per_stage, batch, max_seq,
                 cfg.n_kv_heads, cfg.hd)
        wire = (self.n_stages, batch // self.n_stages,
                self.tokens_per_launch, cfg.d_model)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "wire": torch.zeros(wire, dtype=dtype, device=dev),
                "length": torch.zeros((), dtype=torch.int32, device=dev)}

    # ------------------------------------------------------------------
    def _stack(self, t: torch.Tensor) -> torch.Tensor:
        """[L, ...] -> [n_stages, layers_per_stage, ...]: a view, or a
        zero-padded copy where virtual layers pad the stack."""
        shape = (self.n_stages, self.layers_per_stage) + tuple(t.shape[1:])
        if t.shape[0] == self.n_virtual:
            return t.view(shape)
        pad = t.new_zeros((self.n_virtual - t.shape[0],) + tuple(t.shape[1:]))
        return torch.cat([t, pad]).view(shape)

    def params_from_lm(self, lm_params: Params) -> Params:
        """A ``TransformerLM``'s params in the PP layout: the stacked
        [L, ...] layers as [n_stages, layers_per_stage, ...] views (zero-
        padded copies where virtual layers pad the stack), the embedding
        and final norm as they are, and ``valid``."""
        layers = map_params(self._stack, lm_params["layers"])
        leaf = next(iter(lm_params["final_norm"].values()))
        valid = (torch.arange(self.n_virtual, device=leaf.device)
                 < self.cfg.n_layers)
        return {"emb": lm_params["emb"], "layers": layers,
                "final_norm": lm_params["final_norm"],
                "valid": valid.view(self.n_stages, self.layers_per_stage)}

    def state_from_lm(self, state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """A ``TransformerLM`` decode state ([L, B, S, Hkv, hd] caches, a
        ``[]`` length) in the PP layout, with a zero wire.  ``k``, ``v``
        and ``length`` share storage with ``state`` where no virtual layer
        pads the stack: clone it first to keep both."""
        B, D = state["k"].shape[1], self.cfg.d_model
        wire = state["k"].new_zeros((self.n_stages, B // self.n_stages,
                                     self.tokens_per_launch, D))
        return {"k": self._stack(state["k"]), "v": self._stack(state["v"]),
                "wire": wire, "length": state["length"]}

    # ------------------------------------------------------------------
    def param_specs(self) -> Params:
        sa, ta = self.stage_axis, self.tp_axis

        def spec(path: tuple, leaf: Spec) -> Any:
            name = path[-1]
            nd = len(leaf.shape)
            if path[0] == "layers":
                if name == "wq":
                    return P(sa, None, None, ta, None)
                if name in ("wk", "wv"):
                    return P(sa, None, None, None, None)
                if name == "wo":
                    return P(sa, None, ta, None, None)
                if name in ("w_gate", "w_up"):
                    return P(sa, None, None, ta)
                if name == "w_down":
                    return P(sa, None, ta, None)
                return P(*([sa] + [None] * (nd - 1)))
            if path[0] == "emb":
                return P(ta, None) if name == "embed" else P(None, ta)
            if path[0] == "valid":
                return P(sa, None)
            return P()

        def walk(tree: Any, path: tuple) -> Any:
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            return spec(path, tree)

        return walk(pp_param_specs(self.cfg, self.n_stages,
                                   self.layers_per_stage), ())

    def state_specs(self) -> Dict[str, Any]:
        sa, ta = self.stage_axis, self.tp_axis
        return {"k": P(sa, None, None, ta, None, None),
                "v": P(sa, None, None, ta, None, None),
                "wire": P(sa, None, None, None),
                "length": P()}

    def shard_params(self, params: Params) -> Params:
        """This rank's blocks of the global PP params (views where a block
        is contiguous: all of it on a one-rank mesh)."""
        return map_specs(lambda s, t: local_shard(t, s, self.mesh),
                         self.param_specs(), params)

    def shard_state(self, state: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's blocks of the global PP state, as
        :meth:`shard_params`."""
        return map_specs(lambda s, t: local_shard(t, s, self.mesh),
                         self.state_specs(), state)

    # ------------------------------------------------------------------
    def make_local_step(self, batch: int, max_seq: int
                        ) -> Callable[[Params, Dict[str, torch.Tensor],
                                       torch.Tensor], torch.Tensor]:
        """``launch(local_params, local_state, tokens) -> logits``: one
        launch of T tokens [B, T] for every sequence on this rank's blocks;
        the local state is updated in place (cache rows, wire, length + T)
        and the local logits [B, T, V/tp] (fp32) returned."""
        cfg, mesh = self.cfg, self.mesh
        sa, ta = self.stage_axis, self.tp_axis
        n_stages, tp = self.n_stages, self.tp
        n_micro = n_stages
        lps = self.layers_per_stage
        T = self.tokens_per_launch
        if batch % n_micro or max_seq % tp:
            raise ValueError(f"batch {batch} must divide into {n_micro} "
                             f"microbatches and max_seq {max_seq} into {tp} "
                             f"slices")
        mb = batch // n_micro
        seq_loc = max_seq // tp
        H, hk, hd, D = cfg.n_heads_padded, cfg.n_kv_heads, cfg.hd, cfg.d_model
        h_loc = H // tp
        n_rep = H // hk
        v_loc = cfg.vocab_padded // tp
        scale = hd ** -0.5
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        # sqrt(D) rounded to the activation type, as layers.embed scales
        emb_scale = float(torch.tensor(D ** 0.5, dtype=dtype_of(cfg)))

        def embed_local(emb: torch.Tensor, ids: torch.Tensor, t_idx: int
                        ) -> torch.Tensor:
            off = t_idx * v_loc
            local = (ids - off).clamp(0, v_loc - 1).long()
            rows = emb[local]
            ok = (ids >= off) & (ids < off + v_loc)
            return psum(torch.where(ok[..., None], rows, 0), ta)

        def layer_decode(lp: Params, valid: torch.Tensor, x: torch.Tensor,
                         k_c: torch.Tensor, v_c: torch.Tensor,
                         pos_tok: torch.Tensor, t_idx: int,
                         gpos: torch.Tensor) -> torch.Tensor:
            """x: [mb, T, D] (a T-token segment, causal by write-then-
            score); k_c/v_c: [mb, seq_loc, hk, hd] (the local sequence
            slice), written in place."""
            ap = lp["attn"]
            h = rms_norm(lp["ln1"], x)
            q = torch.einsum("bsd,dhk->bshk", h, ap["wq"])     # h_loc heads
            k_new = torch.einsum("bsd,dhk->bshk", h, ap["wk"])  # hk heads
            v_new = torch.einsum("bsd,dhk->bshk", h, ap["wv"])
            if cfg.qk_norm:
                q = rms_norm(ap["q_norm"], q)
                k_new = rms_norm(ap["k_norm"], k_new)
            positions = pos_tok + torch.arange(T, dtype=pos_tok.dtype,
                                               device=pos_tok.device)
            if cfg.pos_embed == "rope":
                sin, cos = rotary(positions[None], hd, cfg.rope_theta)
                q = apply_rope(q, sin, cos)
                k_new = apply_rope(k_new, sin, cos)
            # ---- masked seq-sharded cache writes (one row per token) -----
            # write-then-score keeps intra-segment causality: token j's row
            # is in the cache before any token scores it, and token j's own
            # position mask hides rows > pos_tok + j
            for j in range(T):
                pj = positions[j]
                owner = (torch.div(pj, seq_loc, rounding_mode="floor")
                         == t_idx) & valid
                row = torch.remainder(pj, seq_loc).long().reshape(1)
                for c, new in ((k_c, k_new), (v_c, v_new)):
                    keep = c.index_select(1, row)
                    c.index_copy_(1, row, torch.where(
                        owner, new[:, j:j + 1].to(c.dtype), keep))
            # ---- flash-decoding over the local sequence slice ------------
            # the tp axis partitions the SEQUENCE inside attention: gather
            # the (tiny) q so every rank scores ALL heads over its slice,
            # then combine per head across slices with pmax/psum and slice
            # back to the local head block for the o-proj partial.  One
            # product per KV group reads its [mb, seq_loc, hd] slice of the
            # cache in place.
            q_all = all_gather(q, ta, dim=2, tiled=True)       # [mb,T,H,hd]
            qg = (q_all.to(k_c.dtype).reshape(mb, T, hk, n_rep, hd)
                  .permute(2, 0, 1, 3, 4).reshape(hk, mb, T * n_rep, hd))
            s = qg.new_empty((hk, mb, T * n_rep, seq_loc))
            for g in range(hk):
                torch.matmul(qg[g], k_c[:, :, g].transpose(1, 2), out=s[g])
            s = s.float().mul_(scale)
            tmask = gpos[None, :] <= positions[:, None]       # [T, seq_loc]
            s.view(hk, mb, T, n_rep, seq_loc).masked_fill_(
                ~tmask[:, None, :], NEG)
            m_glob = pmax(s.amax(dim=-1), ta)
            p_ = s.sub_(m_glob[..., None]).exp_()
            l_glob = psum(p_.sum(dim=-1), ta)
            acc = qg.new_empty((hk, mb, T * n_rep, hd))
            for g in range(hk):
                torch.matmul(p_[g].to(v_c.dtype), v_c[:, :, g], out=acc[g])
            acc = psum(acc.float(), ta)
            out = acc / l_glob.clamp_min(1e-30)[..., None]
            out = (out.reshape(hk, mb, T, n_rep, hd).permute(1, 2, 0, 3, 4)
                   .reshape(mb, T, H, hd))
            out = out[:, :, t_idx * h_loc:(t_idx + 1) * h_loc].to(x.dtype)
            attn = psum(torch.einsum("bshk,hkd->bsd", out, ap["wo"]), ta)
            x = x + torch.where(valid, attn, 0).to(x.dtype)
            # ---- MLP ----------------------------------------------------
            m = psum(mlp(lp["mlp"], rms_norm(lp["ln2"], x), cfg.act), ta)
            return x + torch.where(valid, m, 0).to(x.dtype)

        def launch(params: Params, state: Dict[str, torch.Tensor],
                   tokens: torch.Tensor) -> torch.Tensor:
            with axis_env(mesh):
                s_idx, t_idx = axis_index(sa), axis_index(ta)
                # drop the local stage dim (block size 1 along the stage axis)
                layers = map_params(lambda a: a[0], params["layers"])
                valid_l = params["valid"][0]
                kv_k, kv_v = state["k"][0], state["v"][0]
                length = state["length"]
                emb = params["emb"]["embed"]
                x_wire = state["wire"][0]                      # [mb, T, D]
                dev = x_wire.device
                gpos = t_idx * seq_loc + torch.arange(seq_loc, device=dev)
                logits_acc = torch.zeros((n_micro, mb, T, v_loc),
                                         dtype=torch.float32, device=dev)
                for t in range(n_micro):
                    mb_idx = (t - s_idx) % n_micro
                    rows = slice(mb_idx * mb, (mb_idx + 1) * mb)
                    # µbatches that wrapped (t < s) still carry the previous
                    # launch's T-token segment
                    pos_tok = length - T if t < s_idx else length
                    if s_idx == 0:
                        x = embed_local(emb, tokens[rows], t_idx).to(
                            x_wire.dtype)
                        if cfg.embed_scale:
                            x = x * emb_scale
                    else:
                        x = x_wire
                    for l in range(lps):
                        lp = map_params(lambda a: a[l], layers)
                        x = layer_decode(lp, valid_l[l], x, kv_k[l, rows],
                                         kv_v[l, rows], pos_tok, t_idx, gpos)
                    # ---- last stage: unembed, bank logits for this µb ------
                    if s_idx == n_stages - 1:
                        xn = rms_norm(params["final_norm"], x)
                        logits_acc[mb_idx] = unembed(params["emb"], xn)
                    # ---- hop to the next stage ---------------------------
                    x_wire = ppermute(x, sa, perm)
                logits = psum(logits_acc, sa)    # only the last stage's: != 0
                state["wire"][0].copy_(x_wire)
                length.add_(T)
                return logits.reshape(batch, T, v_loc)

        return launch

    def make_step(self, batch: int, max_seq: int
                  ) -> Callable[[Params, Dict[str, torch.Tensor],
                                 torch.Tensor],
                                Any]:
        """``step(params, state, tokens) -> (state, logits)`` on global
        tensors, the reference's ``step``: this rank's blocks are cut, one
        launch runs on them, and the new state and the logits [B, T, V]
        are assembled over the mesh.  The given state is left as it was."""
        launch = self.make_local_step(batch, max_seq)
        ta = self.tp_axis
        s_specs = self.state_specs()

        def body(params: Params, state: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> Any:
            logits = launch(params, state, tokens)
            return state, logits

        run = shard_map(body, self.mesh,
                        in_specs=(self.param_specs(), s_specs, P(None, None)),
                        out_specs=(s_specs, P(None, None, ta)))

        def step(params: Params, state: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> Any:
            return run(params, {k: v.clone() for k, v in state.items()},
                       tokens)

        return step
