"""AEPE helper and JSONL run logging (a copy of ``gqmap_tpu/evals/metrics.py``,
which is numpy: importing it from ``gqmap_tpu`` would pull in JAX).

One JSONL record per evaluation point with iteration, AEPE, logP, wall time
and throughput, in place of the reference's per-iteration ``fprintf``
diagnostics (``gqmap_gpu_mixture.m:71-72``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["aepe", "MetricsLogger"]


def aepe(flow, gt_flow, unknown=None, crop: int = 1) -> float:
    """Average endpoint error with unknown masking and border crop
    (``gqmap_gpu_mixture.m:63-64``)."""
    flow = np.asarray(flow, np.float64).copy()
    gt = np.asarray(gt_flow, np.float64)
    if unknown is not None:
        flow[np.asarray(unknown)] = 0.0
    sl = np.s_[crop:-crop, crop:-crop] if crop else np.s_[:, :]
    d = gt[sl] - flow[sl]
    return float(np.mean(np.sqrt((d * d).sum(-1))))


class MetricsLogger:
    """Append-only JSONL logger; one record per call."""

    def __init__(self, path, run_meta: dict | None = None):
        self.path = os.fspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._t0 = time.time()
        if run_meta:
            self.log(event="run_start", **run_meta)

    def log(self, **record):
        record.setdefault("t", round(time.time() - self._t0, 3))
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=_np_default) + "\n")

    def solver_callback(self, pixels: int):
        """Adapter for :func:`gqmap_tpu_torch.models.gqmap.solve`'s callback."""
        last = {"it": 0, "t": time.time()}

        def cb(it, state, map_flow, aepe_val, logp):
            now = time.time()
            dit = it - last["it"]
            dt = now - last["t"]
            last.update(it=it, t=now)
            self.log(
                event="eval",
                it=it,
                aepe=None if aepe_val is None or np.isnan(aepe_val) else float(aepe_val),
                logp=float(logp),
                sweeps_per_s=round(dit / dt, 3) if dt > 0 else None,
                mpix_sweeps_per_s=round(dit / dt * pixels / 1e6, 3) if dt > 0 else None,
            )

        return cb


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
