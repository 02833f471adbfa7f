"""Coarse-to-fine pyramid driver (``legacy/optical_flow_ctf.m:21-36``).

Port of ``gqmap_tpu/models/ctf.py``. Per level: resize both frames,
upsample-and-double the accumulated warp, backward-warp frame 1 by the
current warp (bilinear ``interp2`` + nearest ``fillmissing``, in float64 on
the run's device), run the single-level GQMAP solver, accumulate the flow.

Deviations from the reference, by design (the JAX module's):
* the warp upsample targets the actual level shape (the reference's
  ``imresize(warp, 2)`` only matches for power-of-two divisible images);
* per-level AEPE compares against the *resized* ground truth (the reference
  crops the full-res GT to the top-left corner at coarse levels,
  ``legacy/gqmap_ctf.m:38``, a scoring artifact not reproduced).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import FlowRange, GQMAPConfig
from ..io.images import imresize
from ..ops.flowviz import flow_to_color
from ..ops.interp import fill_missing_nearest, interp2_linear
from .gqmap import SolveResult, _device, solve

__all__ = ["solve_coarse_to_fine", "CTFResult"]


@dataclasses.dataclass
class CTFResult:
    flow: np.ndarray                 # final accumulated warp (M, N, 2)
    levels: list[SolveResult]
    aepe: float | None               # final-level AEPE vs GT


def _warp_image(I, warp, device=None) -> np.ndarray:
    """Backward-warp ``I`` by ``warp`` (u, v): bilinear sample at
    ``(x - u, y - v)`` then nearest fill of out-of-range NaNs
    (``legacy/optical_flow_ctf.m:30-32``), in float64 on ``device`` (the GPU
    by default)."""
    M, N = I.shape
    x = 1.0 + np.arange(N)[None, :]
    y = 1.0 + np.arange(M)[:, None]
    V = torch.as_tensor(np.asarray(I, np.float64), device=_device(device))
    out = interp2_linear(V, x - warp[..., 0], y - warp[..., 1])
    return fill_missing_nearest(out).cpu().numpy()


def solve_coarse_to_fine(cfg: GQMAPConfig, I1, I2, gt_flow, scales=(1 / 8, 1 / 4, 1 / 2, 1),
                         seed=None, verbose: bool = False, level_init: str = "zero",
                         device=None) -> CTFResult:
    """Pyramid solve with warp accumulation; ``cfg`` is the per-level solver
    preset (typically :meth:`GQMAPConfig.ctf_level`, L=1). ``device`` (the
    GPU by default; ``device="cpu"`` for the CPU) runs the warps and the
    levels' solves.

    ``level_init="zero"`` (default) seeds every level's means at zero, the
    natural prior for a residual solve after warping. The reference instead
    random-initializes each level over the full clamp box
    (``legacy/gqmap_ctf.m`` inherits gpuV2's init), so a level that does not
    converge within its budget adds its leftover random field to the
    accumulated warp; ``level_init="random"`` reproduces that behavior.
    """
    if level_init not in ("zero", "random"):
        raise ValueError(f"unknown level_init {level_init!r}")
    device = _device(device)
    I1 = np.asarray(I1, np.float64)
    I2 = np.asarray(I2, np.float64)
    gt_clean = flow_to_color(np.asarray(gt_flow, np.float64)).flo
    warp = None
    levels = []
    for li, scale in enumerate(scales):
        I1s = imresize(I1, scale)
        I2s = imresize(I2, scale)
        Ms, Ns = I1s.shape
        if warp is None:
            warp = np.zeros((Ms, Ns, 2))
        else:
            warp = imresize(warp, (Ms, Ns)) * 2.0
        I1w = _warp_image(I1s, warp, device)

        # GT-value-derived clamp range at this scale (legacy/gqmap_ctf.m:4)
        gts = gt_clean * scale
        fr = FlowRange(float(gts[..., 0].min()), float(gts[..., 0].max()),
                       float(gts[..., 1].min()), float(gts[..., 1].max()))
        gt_level = imresize(gt_clean, (Ms, Ns)) * scale
        lvl_init_flow = np.zeros((Ms, Ns, 2)) if level_init == "zero" else None
        res = solve(cfg, I1w, I2s, gt_flow=None, flow_range=fr, seed=seed, verbose=verbose,
                    init_flow=lvl_init_flow, device=device)
        if verbose:
            # per-level AEPE vs the residual GT (gt_level - warp)
            b = cfg.border
            d = (gt_level - warp)[b:-b, b:-b] - res.map[b:-b, b:-b]
            level_aepe = float(np.mean(np.sqrt((d * d).sum(-1))))
            print(f"[ctf level {li}] scale={scale} residual AEPE={level_aepe:.4f}")
        levels.append(res)
        warp = warp + res.map

    d = gt_clean[1:-1, 1:-1] - warp[1:-1, 1:-1]
    aepe = float(np.mean(np.sqrt((d * d).sum(-1))))
    return CTFResult(flow=warp, levels=levels, aepe=aepe)
