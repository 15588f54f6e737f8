"""Submission-policy autotuner: measurement -> search -> apply.

The port's copy of ``repro.tune``.  The paper's §7 closes on the observation
that CUDA *hides* exactly the submission knobs it should expose — the
inline/direct DMA threshold, graph granularity, launch batching — while
Open MPI exposes its protocol thresholds as tunables.  The port exposes
those knobs on CUDA itself (``core/dma.py``'s threshold between a CUDA
Graph replay carrying the payload and a ``cudaMemcpy``; the decode steps of
one ``Server`` graph replay, ``tokens_per_launch``; the train steps of one
``Trainer`` replay, ``steps_per_launch``; the paged engine's page size and
prefill chunk); this package closes the loop:

* :mod:`repro_torch.tune.objective` — scores a candidate from
  :meth:`TraceSession.summary` (host dispatch time, doorbells per token,
  transfer time/bandwidth);
* :mod:`repro_torch.tune.search`    — coordinate descent over discrete knob
  ladders;
* :mod:`repro_torch.tune.policy`    — the learned :class:`Policy` record,
  persisted as JSON per (model config, platform, device count) and
  auto-applied by ``Trainer``/``Server``/``HybridMover``;
* :mod:`repro_torch.tune.env`       — environment presets (CUDA environment
  variables, visible cards) applied before measurement so policies
  record the environment they were learned under;
* :mod:`repro_torch.tune.autotune`  — the measurement workloads and the
  end-to-end ``tune()`` entry point behind ``python -m repro_torch.tune``.
"""
from .env import EnvPreset, snapshot_env
from .objective import Metrics, Objective, ObjectiveWeights, metrics_from_summary
from .policy import (Policy, activate_policy, active_policy, clear_active_policy,
                     default_policy_dir, load_policy, load_policy_for,
                     policy_path, resolve_knob, save_policy)
from .search import Knob, SearchResult, Trial, coordinate_descent, parse_spec, parse_value

__all__ = [
    "EnvPreset", "snapshot_env",
    "Metrics", "Objective", "ObjectiveWeights", "metrics_from_summary",
    "Policy", "activate_policy", "active_policy", "clear_active_policy",
    "default_policy_dir", "load_policy", "load_policy_for", "policy_path",
    "resolve_knob", "save_policy",
    "Knob", "SearchResult", "Trial", "coordinate_descent", "parse_spec",
    "parse_value",
]
