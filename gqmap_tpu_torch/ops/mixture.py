"""Per-site 1-D Gaussian-mixture mode extraction (MAP readout).

Port of ``gqmap_tpu/ops/mixture.py`` (behavioural spec
``legacy/findMixMax.m:39-70``): for every site and flow channel the mode of
``sum_l alpha_l N(x; mu_l, sigma_l)`` is the better of the best component
mean and a bounded golden-section search on ``[min mu, max mu]``, the latter
kept only when it strictly beats the best mean.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mixture_neg_pdf", "mixture_mode_1d", "extract_map"]

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_GOLD = (math.sqrt(5.0) - 1.0) / 2.0  # 0.618...


def mixture_neg_pdf(x, alpha, mu, sigma):
    """``-sum_l alpha_l * normpdf(x, mu_l, sigma_l)``; ``x``: (...),
    ``alpha``: (L,), ``mu``/``sigma``: (..., L)."""
    d = (x[..., None] - mu) / sigma
    comp = alpha * torch.exp(-0.5 * d * d) * (_INV_SQRT_2PI / sigma)
    return -comp.sum(-1)


def mixture_mode_1d(alpha, mu, sigma, iters: int = 80):
    """Mixture mode per site; ``mu, sigma: (..., L)``. ``iters`` golden-section
    steps shrink the bracket by 0.618^iters."""

    def neg(x):
        return mixture_neg_pdf(x, alpha, mu, sigma)

    vals = torch.stack([neg(mu[..., l]) for l in range(mu.shape[-1])], dim=-1)
    spike_val, uid = torch.min(vals, dim=-1)
    spike_x = torch.gather(mu, -1, uid[..., None])[..., 0]

    lo = mu.min(-1).values
    hi = mu.max(-1).values
    a, b = lo, hi
    c = hi - _GOLD * (hi - lo)
    d = lo + _GOLD * (hi - lo)
    fc, fd = neg(c), neg(d)
    for _ in range(iters):
        take_left = fc < fd   # shrink toward the smaller endpoint value
        a, b = torch.where(take_left, a, c), torch.where(take_left, d, b)
        c = b - _GOLD * (b - a)
        d = a + _GOLD * (b - a)
        fc, fd = neg(c), neg(d)
    x_cont = 0.5 * (a + b)
    f_cont = neg(x_cont)
    return torch.where(f_cont < spike_val, x_cont, spike_x)


def extract_map(alpha, muu, sigmau, muv, sigmav):
    """Flow MAP per pixel: ``(M, N, 2)`` from ``(L, M, N)`` state arrays
    (``get_map_mex``, ``gqmap_gpu_mixture.m:53-58``). For ``L == 1`` the mode
    is the mean."""
    if muu.shape[0] == 1:
        return torch.stack([muu[0], muv[0]], dim=-1)
    u = mixture_mode_1d(alpha, torch.movedim(muu, 0, -1), torch.movedim(sigmau, 0, -1))
    v = mixture_mode_1d(alpha, torch.movedim(muv, 0, -1), torch.movedim(sigmav, 0, -1))
    return torch.stack([u, v], dim=-1)
