"""Finds the benchmark's parts by name: a cell, its configuration and its
traffic mix are JSON files under ``bench/cells``, ``bench/configs`` and
``bench/traffic``; a metric is a reader ``bench/metrics/<name>.py``; a
configuration's plain reference is ``bench/reference/<family>.py``.  Which
metrics a cell reports, with their units, comes from ``BENCHMARK.json`` at
the root of the checkout.  Adding a cell, a configuration, a mix or a metric
adds files and edits none of these."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as f:
        return json.load(f)


def cell(name: str, base: Path = HERE) -> Dict[str, Any]:
    return _json(base / "cells" / f"{name}.json")


def config(name: str, base: Path = HERE) -> Dict[str, Any]:
    return _json(base / "configs" / f"{name}.json")


def mix(name: str, base: Path = HERE) -> Dict[str, Any]:
    return _json(base / "traffic" / f"{name}.json")


def peaks(card: str, base: Path = HERE) -> Dict[str, float]:
    """The published peaks of ``card`` (its ``torch.cuda`` name)."""
    table = _json(base / "peaks.json")
    if card in table:
        return table[card]
    # another name of the same part (the H100 entry for an H100 card)
    same = [k for k in table if k.split()[1] in card.split()]
    if len(same) == 1:
        return table[same[0]]
    raise KeyError(f"no peaks for {card!r} in {base / 'peaks.json'}")


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def metrics_of(cell_name: str, trace: bool, root: Path = ROOT
               ) -> List[Dict[str, Any]]:
    """The metrics ``BENCHMARK.json`` has a cell report: its end-to-end
    metrics without tracing, its per-layer metrics with it.  A metric
    without ``workloads`` is every cell's."""
    spec = benchmark(root)
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, base: Path = HERE) -> ModuleType:
    """The module ``bench/metrics/<name>.py``; its ``read(run)`` returns the
    metric or None where the run holds nothing to read."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str) -> ModuleType:
    """The plain reference of a configuration family."""
    return importlib.import_module(f"bench.reference.{family}")


def resolve(cell_name: str, base: Path = HERE) -> Dict[str, Any]:
    """A cell with its configuration and mix loaded in place."""
    c = dict(cell(cell_name, base))
    c["config_spec"] = config(c["config"], base)
    c["mix_spec"] = mix(c["traffic"], base)
    return c
