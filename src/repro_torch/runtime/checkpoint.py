"""Checkpoints: one raw-byte ``.npy`` a leaf plus a JSON manifest, the
port's copy of ``repro.runtime.checkpoint`` with its layout.

* atomic: written to ``<dir>/tmp.<step>`` and renamed to
  ``<dir>/step_<step:08d>`` on completion;
* async: :func:`save_async` snapshots every leaf to host memory now (a
  device-to-host copy) and writes on a background thread;
* restart-exact: the manifest stores the step and the data cursor.

Leaves are keyed by their path as the reference keys them (dict keys
sorted, tuple positions by index, joined by ``/``), and stored as their raw
bytes with their shape and type name (``bfloat16`` too, with no
``ml_dtypes``), so the two packages' checkpoints have one layout.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import tree_unflatten

__all__ = ["save", "save_async", "restore", "latest_step", "CheckpointManager"]

_MANIFEST = "manifest.json"


class HostLeaf(NamedTuple):
    """One leaf's bytes on the host, with its shape and type name."""
    raw: np.ndarray          # uint8, flat
    shape: Tuple[int, ...]
    dtype: str


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _host(leaf: Any) -> HostLeaf:
    if isinstance(leaf, HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().copy()
        return HostLeaf(raw, tuple(t.shape), _dtype_name(t))
    a = np.ascontiguousarray(np.asarray(leaf))
    return HostLeaf(a.view(np.uint8).reshape(-1).copy(), a.shape, str(a.dtype))


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, HostLeaf):
        return [(prefix[:-1], tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic checkpoint write."""
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": [],
                                "extra": extra or {}}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        h = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), h.raw)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(h.shape), "dtype": h.dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None) -> threading.Thread:
    """Snapshot every leaf to the host now; write to disk in the background."""
    host = tree_unflatten(tree, [_host(x) for _, x in _flatten(tree)])
    t = threading.Thread(target=save, args=(ckpt_dir, step, host, extra),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                 if d.startswith("step_")]
    except FileNotFoundError:
        return None
    return max(steps) if steps else None


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint leaf of unknown type {name!r}")
    return dt


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``tree_like``: each leaf a new tensor
    in the stored type, on its ``tree_like`` leaf's device and in its
    shape."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    new_leaves = []
    for key, leaf in _flatten(tree_like):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        raw = torch.from_numpy(np.load(os.path.join(d, meta["file"])))
        t = raw.view(_torch_dtype(meta["dtype"])).reshape(meta["shape"])
        if isinstance(leaf, torch.Tensor):
            # the reference stores a scalar as [1] (np.ascontiguousarray)
            if t.numel() != leaf.numel():
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{meta['shape']}, expected "
                                 f"{list(leaf.shape)}")
            t = t.reshape(leaf.shape).to(leaf.device)
        new_leaves.append(t)
    return (tree_unflatten(tree_like, new_leaves), step,
            manifest.get("extra", {}))


class CheckpointManager:
    """keep_last_n retention + async save handles."""

    def __init__(self, ckpt_dir: str, keep_last_n: int = 3,
                 every_steps: int = 100) -> None:
        self.dir = ckpt_dir
        self.keep = keep_last_n
        self.every = every_steps
        self._pending: List[threading.Thread] = []
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> bool:
        if step % self.every:
            return False
        self._pending.append(save_async(self.dir, step, tree, extra))
        self._gc()
        return True

    def wait(self) -> None:
        for t in self._pending:
            t.join(timeout=60)
        self._pending.clear()

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
