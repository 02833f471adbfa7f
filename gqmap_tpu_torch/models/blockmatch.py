"""Block-matching cost-volume flow initializer (``legacy/optical_flow_temp.m:13-32``).

Port of ``gqmap_tpu/models/blockmatch.py``. The cost of an integer offset
(du, dv) is ``conv2(|I2 - shift(I1)|, G, 'same')`` with a normalized
Gaussian window (``legacy/Gaussian_filter.m``); the argmin over the
+-U x +-V window gives an integer flow field that initializes the GQMAP
solvers (``solve(init_flow=...)``). The (2U+1)(2V+1) shifted
absolute-difference maps are stacked as a batch and smoothed by one
``conv2d``, in float32 as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cosine import no_tf32

__all__ = ["gaussian_window", "block_matching_init"]


def gaussian_window(size: int, sigma: float) -> np.ndarray:
    """Normalized 2-D Gaussian kernel (``legacy/Gaussian_filter.m:1-21``)."""
    half = (size - 1) / 2.0
    x = np.arange(size) - half
    g = np.exp(-(x[None, :] ** 2 + x[:, None] ** 2) / (2.0 * sigma * sigma))
    return g / g.sum()


def block_matching_init(I1, I2, U: int = 7, V: int = 7, ft: int = 3, sigma: float = 1.7,
                        device=None) -> np.ndarray:
    """Integer flow init by windowed block matching.

    Returns an (M, N, 2) float32 array of (u, v) displacements in
    ``[-V, V] x [-U, U]`` (u = columns, v = rows), with the reference's
    ``umt = U+1-fu`` sign convention (``legacy/optical_flow_temp.m:31-32``);
    of equal costs the first offset wins, as ``argmin`` picks it in both
    packages. ``device`` defaults to the GPU (``device="cpu"`` for the CPU).
    On the GPU the convolution runs in full float32: cuDNN's TF32 default
    keeps ~3 decimal digits, enough to move the argmin, so it is switched
    off for the call and restored after it.
    """
    from .gqmap import _device

    device = _device(device)
    I1 = torch.as_tensor(np.asarray(I1), dtype=torch.float32, device=device)
    I2 = torch.as_tensor(np.asarray(I2), dtype=torch.float32, device=device)
    M, N = I1.shape
    ext = I1.new_zeros((M + 2 * U, N + 2 * V))
    ext[U:M + U, V:N + V] = I1
    vol = torch.stack([(I2 - ext[du:du + M, dv:dv + N]).abs()
                       for du in range(2 * U + 1) for dv in range(2 * V + 1)])  # (C, M, N)
    g = torch.as_tensor(gaussian_window(2 * ft + 1, sigma), dtype=torch.float32, device=device)
    with no_tf32():
        smoothed = torch.nn.functional.conv2d(vol[:, None], g[None, None], padding=ft)[:, 0]
    idx = torch.argmin(smoothed, dim=0)
    # MATLAB ind2sub over (du, dv), built du-major and dv-minor
    fu = idx // (2 * V + 1)
    fv = idx % (2 * V + 1)
    u = (V - fv).to(torch.float32)
    v = (U - fu).to(torch.float32)
    return torch.stack([u, v], dim=-1).cpu().numpy()
