"""Gauss-quadrature expectation gradients over bivariate Gaussians.

Port of ``gqmap_tpu/ops/gq.py``: the raw-sum and finalized-gradient records,
the K^2-point tensor rule (:func:`gq_accumulate`, the exact path's node term
and the plain version of kernel K3), the difference-reduced 1-D rule for edge
potentials (:func:`gq_accumulate_diff`), and the finalizers that apply the
alpha weighting and Bethe-entropy terms (``gqmap_gpu_mixture.m:87-146``);
for the legacy estimators the chain-rule sums of the Prewitt family
(:func:`gq_accumulate_chain`, :func:`finalize_chain`) and the bare
expectations that ``torch.autograd`` differentiates in the autodiff family
(:func:`gq_ei`, :func:`gq_ei_diff`), with their exact derivatives from
adjoint sums (:func:`chain_partials` of the chain-rule sums on a potential's
exact derivatives, :func:`gq_ei_diff_adjoint` and :func:`diff_partials`),
which kernels K13-K15 compute.
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

__all__ = ["GQRaw", "GQGrads", "GQChainRaw", "gq_accumulate", "gq_accumulate_diff",
           "gq_accumulate_chain", "gq_ei", "gq_ei_diff", "gq_ei_diff_adjoint", "gq_expectation",
           "finalize", "finalize_chain", "finalize_closed", "chain_partials", "diff_partials",
           "NODE", "EDGE"]

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


class GQChainRaw(NamedTuple):
    """Raw sums of the chain-rule (image-gradient) estimator."""

    Ei: torch.Tensor   # sum w f
    A1: torch.Tensor   # sum w df/dx1
    A2: torch.Tensor   # sum w df/dx2
    Ci: torch.Tensor   # sum w df/dx1 XI
    Cj: torch.Tensor   # sum w df/dx1 XJ
    Di: torch.Tensor   # sum w df/dx2 XI
    Dj: torch.Tensor   # sum w df/dx2 XJ


def _floor_tiny(c: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(c, tiny)``: NaN kept, and differentiated as JAX does,
    1/2 at ``c == tiny`` (``clamp``'s derivative there is 1). The bound is
    filled on the device, so a graph capture copies nothing from the host."""
    return torch.maximum(c, torch.full((), torch.finfo(c.dtype).tiny, dtype=c.dtype,
                                       device=c.device))


def _stacked(tab, like: torch.Tensor) -> torch.Tensor:
    """``tab`` as a ``(fields, steps, chunk)`` tensor of ``like``'s type and
    device: a table from :func:`.quadrature.table_on` as it is, a host table
    copied (on every call, which a CUDA graph capture refuses)."""
    if isinstance(tab, torch.Tensor):
        return tab
    return torch.as_tensor(np.stack(tab), dtype=like.dtype, device=like.device)


def _whitened_steps(u1, u2, o1, o2, p, tab: QuadTable | torch.Tensor):
    """Per table step: ``(row, zi, zj, x1, x2)``, the step's table row
    ``(xi, xj, wiwj, xixj, x2a, x2m)`` (chunk axis leading), the points under
    the spectral whitening and the sample positions ``x1 = sqrt2 o1 zi + u1``,
    ``x2 = sqrt2 o2 zj + u2``."""
    s = (torch.sqrt(1.0 + p) + torch.sqrt(1.0 - p)) * 0.5
    t = (torch.sqrt(1.0 + p) - torch.sqrt(1.0 - p)) * 0.5
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    table = _stacked(tab, u1)
    pts = (table.shape[2],) + (1,) * len(site)
    for step in range(table.shape[1]):
        row = tuple(r.reshape(pts) for r in table[:, step])
        xi, xj = row[:2]
        zi = s * xi + t * xj
        zj = t * xi + s * xj
        yield row, zi, zj, o1e * zi + u1, o2e * zj + u2


def gq_accumulate(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], u1, u2, o1, o2,
                  p, tab: QuadTable | torch.Tensor) -> GQRaw:
    """The six raw sums of ``f`` under the tensor rule, over every site.

    ``f(x1, x2)`` receives sample arrays of shape ``(chunk,) + site_shape``
    (the chunk axis leads) and returns the same shape; the site arrays
    broadcast together to ``site_shape``. One step per table chunk, so peak
    memory is a chunk's worth of samples; pad points have zero weight.
    """
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    raw = GQRaw(*(torch.zeros(site, dtype=u1.dtype, device=u1.device) for _ in GQRaw._fields))
    for (_, _, wiwj, xixj, x2a, x2m), zi, zj, x1, x2 in _whitened_steps(u1, u2, o1, o2, p, tab):
        fv = wiwj * f(x1, x2)
        raw.Ei.add_(fv.sum(0))
        raw.Z1.add_((fv * zi).sum(0))
        raw.Z2.add_((fv * zj).sum(0))
        raw.Sa.add_((fv * (x2a - 1.0)).sum(0))
        raw.Sm.add_((fv * x2m).sum(0))
        raw.Sxy.add_((fv * xixj).sum(0))
    return raw


def gq_accumulate_diff(gd: Callable[[torch.Tensor], torch.Tensor], u1, u2, o1, o2, p,
                       tab: QuadTable1D | torch.Tensor) -> GQRaw:
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
    c = _floor_tiny(c)
    rc = torch.sqrt(c)

    site = torch.broadcast_shapes(delta.shape, c.shape)
    pts = (-1,) + (1,) * len(site)
    x, w = (r.reshape(pts) for r in _stacked(tab, c))
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


def gq_ei(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], u1, u2, o1, o2, p,
          tab: QuadTable | torch.Tensor) -> torch.Tensor:
    """Ei only (the weighted sum of potential values): the autodiff
    estimator's expectation, whose parameter gradients come from
    ``torch.autograd`` rather than the Stein identities. Accumulated out of
    place, one table step at a time, so autograd can differentiate it."""
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    out = torch.zeros(site, dtype=u1.dtype, device=u1.device)
    for (_, _, wiwj, *_), _, _, x1, x2 in _whitened_steps(u1, u2, o1, o2, p, tab):
        out = out + (wiwj * f(x1, x2)).sum(0)
    return out


def gq_accumulate_chain(fg: Callable, u1, u2, o1, o2, p,
                        tab: QuadTable | torch.Tensor) -> GQChainRaw:
    """The chain-rule estimator's sums over every site (``legacy/gqmap_gpuV3.m:91-125``).

    ``fg(x1, x2) -> (f, df/dx1, df/dx2)`` gives the potential and its
    spatial derivatives (from precomputed image-gradient fields); the
    parameter gradients come from quadrature of ``df/dx``, not of the
    integrand times a polynomial as in the Stein identities.
    """
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    raw = [torch.zeros(site, dtype=u1.dtype, device=u1.device) for _ in GQChainRaw._fields]
    for (xi, xj, wiwj, *_), _, _, x1, x2 in _whitened_steps(u1, u2, o1, o2, p, tab):
        f, g1, g2 = fg(x1, x2)
        w1 = wiwj * g1
        w2 = wiwj * g2
        for acc, term in zip(raw, (wiwj * f, w1, w2, w1 * xi, w1 * xj, w2 * xi, w2 * xj)):
            acc.add_(term.sum(0))
    return GQChainRaw(*raw)


def finalize_chain(raw: GQChainRaw, a, o1, o2, p, T, entropy_scale: float) -> GQGrads:
    """Chain-rule sums -> finalized gradients.

    With ``x1 = sqrt2 o1 (s XI + t XJ) + u1`` (and symmetrically x2),

        dE/du1 = E[df/dx1]
        dE/do1 = sqrt2 E[df/dx1 (s XI + t XJ)]
        dE/dp  = sqrt2 ( o1 E[df/dx1 (ds XI + dt XJ)] + o2 E[df/dx2 (dt XI + ds XJ)] ),
        ds = (1/sqrt(1+p) - 1/sqrt(1-p))/4,   dt = (1/sqrt(1+p) + 1/sqrt(1-p))/4

    (``legacy/gqmap_gpuV3.m:95-114``), then the alpha and Bethe-entropy
    finalization of :func:`finalize_closed`.
    """
    inv_pi = 1.0 / math.pi
    q = torch.sqrt(1.0 + p)
    r = torch.sqrt(1.0 - p)
    s = (q + r) * 0.5
    t = (q - r) * 0.5
    ds = (1.0 / q - 1.0 / r) * 0.25
    dt = (1.0 / q + 1.0 / r) * 0.25
    dEdo1 = _SQRT2 * (s * raw.Ci + t * raw.Cj) * inv_pi
    dEdo2 = _SQRT2 * (t * raw.Di + s * raw.Dj) * inv_pi
    dEdp = _SQRT2 * (o1 * (ds * raw.Ci + dt * raw.Cj) + o2 * (dt * raw.Di + ds * raw.Dj)) * inv_pi
    return finalize_closed(raw.Ei * inv_pi, raw.A1 * inv_pi, raw.A2 * inv_pi, dEdo1, dEdo2,
                           dEdp, a, o1, o2, p, T, entropy_scale)


def gq_ei_diff(gd: Callable[[torch.Tensor], torch.Tensor], u1, u2, o1, o2, p,
               tab: QuadTable1D | torch.Tensor) -> torch.Tensor:
    """Ei by the 1-D difference-reduced rule, ``sqrt(pi) sum_k w_k gd(d_k)``:
    the expectation of a difference potential ``f(x1, x2) = gd(x1 - x2)``
    needs only the marginal ``d ~ N(u1 - u2, o1e^2 + o2e^2 - 2 p o1e o2e)``.
    Differentiable in all five parameters (the autodiff estimator with
    ``edge_quad="reduced"``)."""
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    delta = u1 - u2
    c = o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e
    c = _floor_tiny(c)
    rc = torch.sqrt(c)
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    pts = (-1,) + (1,) * len(site)
    h0 = torch.zeros(site, dtype=u1.dtype, device=u1.device)
    table = _stacked(tab, c)
    for step in range(table.shape[1]):
        x, w = (r.reshape(pts) for r in table[:, step])
        h0 = h0 + (w * gd(delta + rc * x)).sum(0)
    return math.sqrt(math.pi) * h0


def chain_partials(raw: GQChainRaw, o1, o2, p):
    """The derivatives of ``Ei`` (:func:`gq_ei`'s value, the weighted sum of
    ``f``) with respect to ``(u1, u2, o1, o2, p)``, from the chain-rule sums
    of ``f`` with its exact derivatives: :func:`finalize_chain`'s formulas
    without the 1/pi, the alpha weighting and the entropy terms,

        dEi/du1 = A1,   dEi/do1 = sqrt2 (s Ci + t Cj),
        dEi/dp  = sqrt2 ( o1 (ds Ci + dt Cj) + o2 (dt Di + ds Dj) ),

    and the same for endpoint 2; what ``jax.grad`` takes of the JAX
    package's ``gq_ei``, since ``x1 = sqrt2 o1 (s XI + t XJ) + u1``."""
    q = torch.sqrt(1.0 + p)
    r = torch.sqrt(1.0 - p)
    s = (q + r) * 0.5
    t = (q - r) * 0.5
    ds = (1.0 / q - 1.0 / r) * 0.25
    dt = (1.0 / q + 1.0 / r) * 0.25
    return (raw.A1, raw.A2, _SQRT2 * (s * raw.Ci + t * raw.Cj),
            _SQRT2 * (t * raw.Di + s * raw.Dj),
            _SQRT2 * (o1 * (ds * raw.Ci + dt * raw.Cj) + o2 * (dt * raw.Di + ds * raw.Dj)))


def gq_ei_diff_adjoint(gdd: Callable, u1, u2, o1, o2, p,
                       tab: QuadTable1D | torch.Tensor) -> tuple:
    """The adjoint sums of :func:`gq_ei_diff`: with ``gdd(d) -> (gd(d),
    gd'(d))`` and ``d_k = delta + sqrt(c) x_k`` as there (``c`` floored at
    the smallest normal number), ``(H0, G0, G1) = (sum w gd(d), sum w gd'(d),
    sum w gd'(d) x)``; :func:`diff_partials` turns them into the value and
    its derivatives."""
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    delta = u1 - u2
    c = _floor_tiny(o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e)
    rc = torch.sqrt(c)
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    pts = (-1,) + (1,) * len(site)
    sums = [torch.zeros(site, dtype=u1.dtype, device=u1.device) for _ in range(3)]
    table = _stacked(tab, c)
    for step in range(table.shape[1]):
        x, w = (r.reshape(pts) for r in table[:, step])
        gv, dv = gdd(delta + rc * x)
        wd = w * dv
        for acc, term in zip(sums, (w * gv, wd, wd * x)):
            acc.add_(term.sum(0))
    return tuple(sums)


def diff_partials(sums, o1, o2, p):
    """``(Ei, dEi/du1, dEi/du2, dEi/do1, dEi/do2, dEi/dp)`` of
    :func:`gq_ei_diff` from its adjoint sums (:func:`gq_ei_diff_adjoint`),
    chained through ``delta = u1 - u2`` and ``c = max(o1e^2 + o2e^2 - 2 p
    o1e o2e, tiny)`` as ``jax.grad`` chains the JAX function: ``dEi/dc =
    sqrt(pi) G1 / (2 sqrt(c))`` times the floor's slope, 1 above ``tiny``,
    1/2 on it (``lax.max``'s tie rule), 0 below."""
    H0, G0, G1 = sums
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    c_raw = o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e
    tiny = torch.finfo(c_raw.dtype).tiny
    slope = torch.where(c_raw > tiny, 1.0, torch.where(c_raw == tiny, 0.5, 0.0)).to(c_raw.dtype)
    rc = torch.sqrt(_floor_tiny(c_raw))
    sq_pi = math.sqrt(math.pi)
    dc = sq_pi * G1 * 0.5 / rc * slope
    du = sq_pi * G0
    return (sq_pi * H0, du, -du, dc * (2.0 * _SQRT2) * (o1e - p * o2e),
            dc * (2.0 * _SQRT2) * (o2e - p * o1e), dc * (-2.0) * o1e * o2e)


def gq_expectation(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], u1, u2, o1, o2,
                   p, tab: QuadTable | torch.Tensor) -> torch.Tensor:
    """Plain quadrature estimate of ``E_q[f]``, ``Ei / pi`` (no gradients)."""
    return gq_accumulate(f, u1, u2, o1, o2, p, tab).Ei / math.pi


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
