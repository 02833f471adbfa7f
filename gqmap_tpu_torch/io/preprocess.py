"""Structure-texture decomposition preprocessing (ROF / Chambolle).

Port of ``gqmap_tpu/io/preprocess.py``, the generator of the structure-
texture inputs that the reference ships only as opaque ``.mat`` files
(``optical_flowSuper.m:12-14``):

1. structure = ROF (total-variation) denoising of the frame, solved with
   Chambolle's dual projection algorithm (a fixed number of iterations);
2. texture = frame - structure;
3. output = blend * texture + (1 - blend) * structure.

Intensities are normalized to [-1, 1] during the solve and the output is
rescaled to the input range. The JAX package runs the iterations as one
jitted ``fori_loop``; here they are a plain torch loop over the same
forward-difference gradient and its adjoint divergence, in float64 on an
explicit ``device`` (the GPU by default), which matches the JAX package's
x64 results. It is ~15 elementwise passes an iteration over one frame, once
per frame, so no kernel is written for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gqmap import _device

__all__ = ["rof_structure", "structure_texture"]


def _grad(u: torch.Tensor):
    gx = torch.cat([u[:, 1:] - u[:, :-1], torch.zeros_like(u[:, :1])], dim=1)
    gy = torch.cat([u[1:, :] - u[:-1, :], torch.zeros_like(u[:1, :])], dim=0)
    return gx, gy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]], dim=1)
    dy = torch.cat([py[:1, :], py[1:-1, :] - py[:-2, :], -py[-2:-1, :]], dim=0)
    return dx + dy


def _chambolle(f: torch.Tensor, theta: float, tau: float, iters: int) -> torch.Tensor:
    """ROF denoising ``argmin_u TV(u) + |u - f|^2 / (2 theta)`` by
    Chambolle's projection algorithm on the dual field p."""
    px = torch.zeros_like(f)
    py = torch.zeros_like(f)
    for _ in range(iters):
        gx, gy = _grad(_div(px, py) - f / theta)
        denom = 1.0 + tau * torch.sqrt(gx * gx + gy * gy)
        px, py = (px + tau * gx) / denom, (py + tau * gy) / denom
    return f - theta * _div(px, py)


def _on(img, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img, np.float64), device=_device(device))


def rof_structure(img, theta: float = 0.125, tau: float = 0.25, iters: int = 100,
                  device=None) -> np.ndarray:
    """The structure (cartoon) component of ``img`` via ROF denoising, in
    float64 on ``device`` (the GPU by default; ``device="cpu"`` for the CPU)."""
    return _chambolle(_on(img, device), theta, tau, iters).cpu().numpy()


def structure_texture(img, blend: float = 0.95, theta: float = 0.125, tau: float = 0.25,
                      iters: int = 100, device=None) -> np.ndarray:
    """Structure-texture preprocessed frame: texture-emphasized blend, input
    range preserved. The defaults are the JAX package's, validated there
    against the reference's shipped inputs (``tests/test_preprocess_parity.py``).
    The Chambolle iterations run in float64 on ``device`` (the GPU by
    default; ``device="cpu"`` for the CPU)."""
    img = np.asarray(img, np.float64)
    lo, hi = float(img.min()), float(img.max())
    scale = (hi - lo) / 2.0 if hi > lo else 1.0
    f = (img - lo) / scale - 1.0  # -> [-1, 1]
    s = _chambolle(_on(f, device), theta, tau, iters).cpu().numpy()
    t = f - s
    out = blend * t + (1.0 - blend) * s
    # rescale to the input intensity range (zero-mean texture re-centered)
    out = (out - out.min()) / max(out.max() - out.min(), 1e-12)
    return out * (hi - lo) + lo
