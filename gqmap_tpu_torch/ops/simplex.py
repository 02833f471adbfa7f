"""Mixture-weight updates (port of ``gqmap_tpu/ops/simplex.py``).

* :func:`project_simplex` — Euclidean projection onto the probability simplex
  (``projsplx.m:15-31``), the alternative alpha update.
* :func:`softmax_natural_step` — the live update: a clamped natural-gradient
  step on softmax logits (``gqmap_gpu_mixture.m:78-86``).
"""

from __future__ import annotations

import torch

__all__ = ["project_simplex", "softmax_natural_step", "softmax"]


def project_simplex(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Euclidean projection of ``y`` onto ``{x >= 0, sum x = 1}`` along ``dim``.

    The MATLAB loop: sort descending, take the FIRST j in 1..n-1 whose
    running threshold ``tmax_j`` is >= the next element, else j = n.
    """
    y = torch.movedim(y, dim, -1)
    n = y.shape[-1]
    s = torch.sort(y, dim=-1, descending=True).values
    css = torch.cumsum(s, dim=-1)
    idx = torch.arange(1, n + 1, dtype=y.dtype, device=y.device)
    tmax = (css - 1.0) / idx
    valid = tmax[..., :-1] >= s[..., 1:]
    first = torch.argmax(valid.to(torch.int8), dim=-1)  # first True
    pick = torch.where(valid.any(dim=-1), first, torch.full_like(first, n - 1))
    t = torch.gather(tmax, -1, pick[..., None])
    x = torch.clamp(y - t, min=0.0)
    return torch.movedim(x, -1, dim)


def softmax(w: torch.Tensor) -> torch.Tensor:
    """``exp(w) / sum(exp(w))`` as the reference writes it (logits are
    clamped to +-300 by the update, so no max-subtraction is needed)."""
    e = torch.exp(w)
    return e / e.sum()


def softmax_natural_step(w: torch.Tensor, dalpha: torch.Tensor, lr,
                         w_clip: float = 300.0) -> torch.Tensor:
    """``dw = alpha*(dalpha - sum(dalpha*alpha)); w = clip(w + dw*lr, +-300)``."""
    alpha = softmax(w)
    dw = alpha * (dalpha - (dalpha * alpha).sum())
    return torch.clamp(w + dw * lr, -w_clip, w_clip)
