"""Hyperparameter grid search over the smoothness weight
(``legacy/LearnRatio.m:5-33``): run the solver across a lambda grid, track
the best AEPE, log results. Port of ``gqmap_tpu/models/param_sweep.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import GQMAPConfig
from .gqmap import solve

__all__ = ["sweep_lambdas", "SweepResult"]


@dataclasses.dataclass
class SweepResult:
    lambdas: np.ndarray
    best_aepe: np.ndarray
    best_lambda: float

    def summary(self) -> str:
        lines = [f"lambda_s={l:.6g}: best AEPE={a:.5f}" for l, a in zip(self.lambdas, self.best_aepe)]
        lines.append(f"Best lambda s = {self.best_lambda:.6g}")
        return "\n".join(lines)


def sweep_lambdas(cfg: GQMAPConfig, I1, I2, gt_flow, lambdas=None, seed=None, log_path=None,
                  verbose: bool = False, device=None) -> SweepResult:
    """Grid-search ``lambdas`` (default: the reference's
    ``linspace(0.300001, 1.0, 12)``), returning per-value best AEPE. Each
    solve runs on ``device`` (the GPU by default; ``device="cpu"`` for the CPU)."""
    if lambdas is None:
        lambdas = np.linspace(0.300001, 1.0, 12)
    lambdas = np.asarray(lambdas, float)
    best = np.empty_like(lambdas)
    for i, lam in enumerate(lambdas):
        c = dataclasses.replace(cfg, lambdas=float(lam))
        res = solve(c, I1, I2, gt_flow=gt_flow, seed=seed, device=device)
        best[i] = res.best_aepe
        if verbose:
            print(f"lambda_s={lam:.6g}: best AEPE={best[i]:.5f}")
    out = SweepResult(lambdas, best, float(lambdas[int(best.argmin())]))
    if log_path is not None:
        with open(log_path, "w") as f:
            f.write(out.summary() + "\n")
    return out
