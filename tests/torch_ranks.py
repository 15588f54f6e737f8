"""Spawned gloo ranks for the port's multi-rank tests.

``run_ranks(tmp_path, case, **kwargs)`` starts ``world`` processes (context
``spawn``), each joining one gloo process group through a ``FileStore``
under ``tmp_path`` (a TCP port could collide across test workers), and runs
``CASES[case](rank, **kwargs)`` in each.  A case reads its inputs from
``.npz`` files the parent test wrote and returns arrays, saved per rank and
returned to the parent.  This module imports torch and the port only: the
JAX reference is computed in the parent test process, never in a rank.

Each call has a time limit of its own (120 s): a rank still running then is
terminated and the test fails, so a hung rank never holds the suite.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np

TIMEOUT_S = 120.0
SRC = str(Path(__file__).resolve().parents[1] / "src")


def save_tree(path: Path, tree: Dict[str, Any]) -> None:
    """A nested dict of arrays as one ``.npz`` with ``a/b/c`` keys."""
    flat: Dict[str, np.ndarray] = {}

    def walk(t: Any, prefix: str) -> None:
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = np.asarray(t)

    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path: Path) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[key]
    return out


def _entry(rank: int, world: int, store: str, case: str,
           kwargs: Dict[str, Any], out: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = CASES[case](rank, **kwargs)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **result)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path: Path, case: str, world: int = 4,
              **kwargs: Any) -> List[Dict[str, np.ndarray]]:
    """Run ``case`` on ``world`` spawned gloo ranks; each rank's arrays."""
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path / f"{case}_out"
    out.mkdir(exist_ok=True)
    store = str(tmp_path / f"{case}_store")
    procs = [ctx.Process(target=_entry, args=(r, world, store, case, kwargs,
                                              str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise AssertionError(f"{case}: ranks {hung} still ran after "
                             f"{TIMEOUT_S:.0f} s; terminated")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"{case}: rank exit codes {codes}")
    result = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            result.append({k: z[k] for k in z.files})
    return result


# --------------------------------------------------------------------------
# cases, run in each rank
# --------------------------------------------------------------------------
def _config(fields: Dict[str, Any]) -> Any:
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**fields)


def pp_case(rank: int, cfg: Dict[str, Any], inputs: str, batch: int,
            max_seq: int, tokens_per_launch: int) -> Dict[str, np.ndarray]:
    """The PP decode on a 2 x 2 mesh (stages over ``data``, TP over
    ``model``), params from the reference's LM params, one global-in /
    global-out ``step`` a launch of the saved tokens [n, B, T]."""
    import torch
    from repro_torch.distributed.pp_decode import PPDecoder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.weights import params_from_jax
    cfg = _config(cfg)
    tree = load_tree(Path(inputs))
    toks = torch.from_numpy(tree.pop("tokens"))
    params = params_from_jax(tree, cfg, device="cpu")
    mesh = make_mesh(2, 2, device="cpu")
    pp = PPDecoder(cfg, mesh, tokens_per_launch=tokens_per_launch)
    pp_params = pp.params_from_lm(params)
    state = pp.init_state(batch, max_seq)
    step = pp.make_step(batch, max_seq)
    logits = []
    for n in range(toks.shape[0]):
        state, lg = step(pp_params, state, toks[n])
        logits.append(lg.numpy())
    return {"logits": np.stack(logits), "valid": pp_params["valid"].numpy(),
            "length": state["length"].numpy()}


def moe_case(rank: int, cfg: Dict[str, Any], inputs: str
             ) -> Dict[str, np.ndarray]:
    """``moe_sorted_smap`` on a 2 x 2 mesh (batch over ``data``, expert FFNs
    over ``model``) on the saved MoE params and input."""
    import torch
    from repro_torch.distributed.context import set_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import map_params
    from repro_torch.models.moe import moe_sorted_smap
    cfg = _config(cfg)
    tree = load_tree(Path(inputs))
    x = torch.from_numpy(tree.pop("x"))
    p = map_params(torch.from_numpy, tree)
    set_mesh(make_mesh(2, 2, device="cpu"), ("data",))
    try:
        y, aux = moe_sorted_smap(p, cfg, x)
    finally:
        set_mesh(None, ())
    return {"y": y.numpy(), "aux": aux.numpy()}


SHARD_SPECS = {"rows_data": ("data", None),
               "cols_model": (None, "model"),
               "both": ("data", "model"),
               "tuple_rows": (("data", "model"), None),
               "swapped": ("model", "data")}


def shard_case(rank: int, shape: List[int]) -> Dict[str, np.ndarray]:
    """This rank's blocks of an arange tensor under each of
    ``SHARD_SPECS``, by ``local_shard`` and by DTensor with
    ``to_placements``; the rank's mesh coordinates and ``process_info``."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.context import local_shard, process_info
    from repro_torch.distributed.sharding import to_placements
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(2, 2, device="cpu")
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    out = {"coord": np.array([mesh.get_local_rank("data"),
                              mesh.get_local_rank("model")])}
    for name, spec in SHARD_SPECS.items():
        out[f"local/{name}"] = local_shard(t, spec, mesh).numpy()
        out[f"dtensor/{name}"] = distribute_tensor(
            t, mesh, to_placements(spec, mesh)).to_local().numpy()
    info = process_info()
    out["info"] = np.array([info["process"], info["process_count"]])
    return out


CASES: Dict[str, Callable[..., Dict[str, np.ndarray]]] = {
    "pp": pp_case, "moe": moe_case, "shard": shard_case}


def config_fields(cfg: Any) -> Dict[str, Any]:
    """A config's fields, to rebuild it in a rank."""
    return dataclasses.asdict(cfg)
