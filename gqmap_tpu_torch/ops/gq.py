"""Gauss-quadrature expectation gradients over bivariate Gaussians.

Port of the Stein-estimator part of ``gqmap_tpu/ops/gq.py``: the raw-sum
and finalized-gradient records, the K^2-point tensor rule
(:func:`gq_accumulate`, the exact path's node term and the plain version of
kernel K3), the difference-reduced 1-D rule for edge potentials
(:func:`gq_accumulate_diff`), and the two finalizers that apply the alpha
weighting and Bethe-entropy terms (``gqmap_gpu_mixture.m:87-146``).
The raw sums are those of the tensor rule under the spectral whitening
``z_i = s XI + t XJ``, ``z_j = t XI + s XJ`` (see the JAX module docstring):

    Ei = sum fv      Z1 = sum fv z_i        Z2 = sum fv z_j
    Sa = sum fv (XI^2+XJ^2-1)   Sm = sum fv (XI^2-XJ^2)   Sxy = sum fv XI XJ
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .quadrature import QuadTable, QuadTable1D

__all__ = ["GQRaw", "GQGrads", "gq_accumulate", "gq_accumulate_diff", "finalize",
           "finalize_closed", "NODE", "EDGE"]

_SQRT2 = math.sqrt(2.0)
_CONST1 = 1.0 + math.log(2.0 * math.pi)  # 1 + log(2*pi), entropy constant

# Bethe counting-number scale of the temperature terms: cn = entropy_scale * T
# with +3 for nodes (degree-1 on the 4-connected grid) and -1 for edges.
NODE = 3.0
EDGE = -1.0


class GQRaw(NamedTuple):
    """Raw quadrature sums (see module docstring)."""

    Ei: torch.Tensor
    Z1: torch.Tensor
    Z2: torch.Tensor
    Sa: torch.Tensor
    Sm: torch.Tensor
    Sxy: torch.Tensor


class GQGrads(NamedTuple):
    """Finalized per-site outputs, matching the reference kernel returns."""

    da: torch.Tensor   # d/d(alpha): expected potential + entropy (per unit weight)
    du1: torch.Tensor
    du2: torch.Tensor
    do1: torch.Tensor
    do2: torch.Tensor
    dp: torch.Tensor
    E: torch.Tensor    # alpha-weighted energy contribution (== a*da)


def gq_accumulate(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], u1, u2, o1, o2,
                  p, tab: QuadTable) -> GQRaw:
    """The six raw sums of ``f`` under the tensor rule, over every site.

    ``f(x1, x2)`` receives sample arrays of shape ``(chunk,) + site_shape``
    (the chunk axis leads) and returns the same shape; the site arrays
    broadcast together to ``site_shape``. One step per table chunk, so peak
    memory is a chunk's worth of samples; pad points have zero weight.
    """
    s = (torch.sqrt(1.0 + p) + torch.sqrt(1.0 - p)) * 0.5
    t = (torch.sqrt(1.0 + p) - torch.sqrt(1.0 - p)) * 0.5
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    pts = (tab.chunk,) + (1,) * len(site)
    table = torch.as_tensor(np.stack(tab), dtype=u1.dtype, device=u1.device)
    raw = GQRaw(*(torch.zeros(site, dtype=u1.dtype, device=u1.device) for _ in GQRaw._fields))
    for step in range(tab.steps):
        xi, xj, wiwj, xixj, x2a, x2m = (r.reshape(pts) for r in table[:, step])
        zi = s * xi + t * xj
        zj = t * xi + s * xj
        fv = wiwj * f(o1e * zi + u1, o2e * zj + u2)
        raw.Ei.add_(fv.sum(0))
        raw.Z1.add_((fv * zi).sum(0))
        raw.Z2.add_((fv * zj).sum(0))
        raw.Sa.add_((fv * (x2a - 1.0)).sum(0))
        raw.Sm.add_((fv * x2m).sum(0))
        raw.Sxy.add_((fv * xixj).sum(0))
    return raw


def gq_accumulate_diff(gd: Callable[[torch.Tensor], torch.Tensor], u1, u2, o1, o2, p,
                       tab: QuadTable1D) -> GQRaw:
    """The six raw sums for a difference potential ``f(x1, x2) = gd(x1 - x2)``.

    Under the whitened Gaussian ``d = x1 - x2`` is 1-D Gaussian with mean
    ``u1 - u2`` and variance ``c = o1e^2 + o2e^2 - 2 p o1e o2e`` (``o*e =
    sqrt2 o*``), and every monomial the tensor rule accumulates has a
    quadratic conditional expectation given ``d``; so a K-point 1-D rule
    with ``H0 = sum w g``, ``H1 = sum w g x``, ``H2 = sum w g (x^2 - 1/2)``
    reproduces the K^2-point sums (derivation in the JAX module).
    """
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    delta = u1 - u2
    c = o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e
    c = torch.clamp(c, min=torch.finfo(c.dtype).tiny)
    rc = torch.sqrt(c)

    site = torch.broadcast_shapes(delta.shape, c.shape)
    pts = (-1,) + (1,) * len(site)
    x = torch.as_tensor(tab.x.reshape(-1), dtype=c.dtype, device=c.device).reshape(pts)
    w = torch.as_tensor(tab.w.reshape(-1), dtype=c.dtype, device=c.device).reshape(pts)
    gv = w * gd(delta + rc * x)
    H0 = gv.sum(0)
    H1 = (gv * x).sum(0)
    H2 = (gv * (x * x - 0.5)).sum(0)

    sq_pi = math.sqrt(math.pi)
    h1s = sq_pi * H1 / rc
    h2s = sq_pi * H2 / c
    sq = o1e * o1e - o2e * o2e
    return GQRaw(
        Ei=sq_pi * H0,
        Z1=(o1e - p * o2e) * h1s,
        Z2=(p * o1e - o2e) * h1s,
        Sa=sq_pi * H2,
        Sm=sq * torch.sqrt(1.0 - p * p) * h2s,
        Sxy=(0.5 * p * (o1e * o1e + o2e * o2e) - o1e * o2e) * h2s,
    )


def finalize(raw: GQRaw, a, o1, o2, p, T, entropy_scale: float) -> GQGrads:
    """Apply the per-site scale factors and temperature (entropy) terms.

    ``entropy_scale`` is :data:`NODE` (+3) or :data:`EDGE` (-1); with
    ``cn = entropy_scale * T`` this is ``gqmap_gpu_mixture.m:107-115`` (node)
    and ``:137-145`` (edge).
    """
    inv_pi = 1.0 / math.pi
    cn = entropy_scale * T
    pr = 1.0 - p * p
    sqrtpr = torch.sqrt(pr)

    du1 = a * (raw.Z1 - p * raw.Z2) * (_SQRT2 / (o1 * pr)) * inv_pi
    du2 = a * (raw.Z2 - p * raw.Z1) * (_SQRT2 / (o2 * pr)) * inv_pi
    da = raw.Ei * inv_pi - cn * (_CONST1 + torch.log(sqrtpr * o1 * o2))
    sm_w = raw.Sm / sqrtpr
    do1 = a * ((raw.Sa + sm_w) * inv_pi - cn) / o1
    do2 = a * ((raw.Sa - sm_w) * inv_pi - cn) / o2
    dp = a * ((2.0 * raw.Sxy - p * raw.Sa) * inv_pi + cn * p) / pr
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp, E=a * da)


def finalize_closed(Ef, dEdu1, dEdu2, dEdo1, dEdo2, dEdp,
                    a, o1, o2, p, T, entropy_scale: float) -> GQGrads:
    """:func:`finalize` for exact derivatives of the expected potential (the
    closed-form cosine data term): the same alpha weighting and entropy
    corrections applied to ``dE/dtheta`` inputs."""
    cn = entropy_scale * T
    pr = 1.0 - p * p
    da = Ef - cn * (_CONST1 + torch.log(torch.sqrt(pr) * o1 * o2))
    du1 = a * dEdu1
    du2 = a * dEdu2
    do1 = a * (dEdo1 - cn / o1)
    do2 = a * (dEdo2 - cn / o2)
    dp = a * (dEdp + cn * p / pr)
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp, E=a * da)
