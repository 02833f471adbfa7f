"""Closed-form cosine-spectral data term: zero quadrature, exact gradients.

Port of ``gqmap_tpu/ops/cosine.py``. The per-pixel displacement-cost surface
is expanded in a tensor-product cosine basis (type-II DCT of midpoint
samples), and the expectation of each mode under a correlated bivariate
Gaussian is its characteristic function:

    E[cos(a*th1(x1)) cos(b*th2(x2))]
      = 1/2 [ cos(a*ph1 - b*ph2) W-  +  cos(a*ph1 + b*ph2) W+ ],
    W∓ = exp(-(a*s1 - b*s2)^2/2 - a*b*s1*s2*(1 ∓ p))          (both args <= 0)

with ``th_u(x) = pi (x - lo_u)/L_u``, ``ph1 = th_u(u1)``, ``s1 = pi o1/L_u``
(likewise for v). The W∓ exponent is kept in this split form (a sum of two
nonpositive terms): the expanded ``-(a^2 s1^2 + b^2 s2^2)/2 ± ab s1 s2 p``
cancels catastrophically at the sigma clamp. The five parameter gradients
are exact derivatives of the truncated expectation, built from six mode sums
(:func:`_mode_sums`); hand-written CUDA kernel K1
(``gqmap_tpu_torch/csrc/cosine_gq.cu``) computes the same six sums. The
expectation alone (:func:`cos_ei`) is differentiable by ``torch.autograd``
for the autodiff estimator. For ``window_rg > 0`` the expansion is of the
window-meaned potential of ``legacy/gqmap_cpuV2.m:29-33``, a box filter of
each constant-shift sample (:func:`_box_mean`).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .gq import GQGrads, finalize_closed
from .interp import sample_bicubic

__all__ = ["CosData", "build_cos_data", "cos_ei", "cos_node_grads"]

# Elements per chunk of constant-shift samples in build_cos_data: bounds the
# 16-tap gather's temporaries (~250 B per element) to about 1 GB.
_SAMPLE_CHUNK_ELEMS = 1 << 22


class CosData(NamedTuple):
    coeffs: torch.Tensor  # (A, B, M, N) cosine coefficients of the node potential
    lo_u: float           # displacement box bounds
    hi_u: float
    lo_v: float
    hi_v: float


def _dct2_matrix(P: int) -> np.ndarray:
    """(P, P) type-II DCT matrix D with coeffs = D @ values-at-midpoints,
    normalized so that ``f(x_j) = sum_a c_a cos(a*pi*(j+1/2)/P)``."""
    k = np.arange(P)
    a = np.arange(P)[:, None]
    D = np.cos(np.pi * a * (k + 0.5) / P) * (2.0 / P)
    D[0] *= 0.5
    return D


def _box_mean(npt: torch.Tensor, rg: int) -> torch.Tensor:
    """Overlapping-window mean of per-pixel cost fields ``(..., M, N)``,
    edge-padded. The spectral build samples at global constant
    displacements, so the windowed cost (mean over the (2rg+1)^2 window,
    displacement shared across it) is exactly a box filter of each sampled
    surface: the window costs nothing at sweep time."""
    k = 2 * rg + 1
    M, N = npt.shape[-2:]
    p = torch.nn.functional.pad(npt.reshape(-1, M, N), (rg, rg, rg, rg), mode="replicate")
    acc = torch.zeros_like(p[:, :M, :N])
    for di in range(k):
        for dj in range(k):
            acc = acc + p[:, di:di + M, dj:dj + N]
    return (acc / (k * k)).reshape(npt.shape)


@contextlib.contextmanager
def no_tf32():
    """Both TF32 switches off, restored on exit. The spectral terms' matrix
    products (XLA's einsum in the JAX package) run in full float32: TF32
    would keep ~3 decimal digits of their f32 coefficients."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _sample_surface(I1: torch.Tensor, VV: torch.Tensor, lambdad: float, epsn: float, us, vs,
                    patch: int = 1, window_rg: int = 0) -> torch.Tensor:
    """The node potential at every global displacement ``(us[p], vs[q])``,
    ``(P * Q, M, N)`` in (p, q) order: each sample a constant-offset bicubic
    read of frame 2 (``VV = pad_cubic(I2)``), window-meaned for
    ``window_rg > 0`` (:func:`_box_mean`) and patch-summed to the
    ``(Mo, No) / patch`` flow lattice for ``patch > 1``; evaluated in chunks
    of full-resolution samples."""
    Mo, No = I1.shape
    M, N = Mo // patch, No // patch
    dtype, device = I1.dtype, I1.device
    uv = np.stack(np.broadcast_arrays(np.asarray(us)[:, None], np.asarray(vs)[None, :]),
                  -1).reshape(-1, 2)
    uv = torch.as_tensor(uv, dtype=dtype, device=device)
    jj = 1.0 + torch.arange(No, dtype=dtype, device=device).reshape(1, No)
    ii = 1.0 + torch.arange(Mo, dtype=dtype, device=device).reshape(Mo, 1)
    vals = torch.empty((len(uv), M, N), dtype=dtype, device=device)
    chunk = max(1, _SAMPLE_CHUNK_ELEMS // (Mo * No))  # full-resolution samples a chunk
    for i in range(0, len(uv), chunk):
        u = uv[i:i + chunk, 0].reshape(-1, 1, 1)
        v = uv[i:i + chunk, 1].reshape(-1, 1, 1)
        Vq = sample_bicubic(VV, jj + u, ii + v)
        npt = -lambdad * torch.sqrt(epsn + (I1 - Vq) ** 2)
        if window_rg > 0:
            npt = _box_mean(npt, window_rg)
        if patch > 1:
            npt = npt.reshape(-1, M, patch, N, patch).sum((-3, -1))
        vals[i:i + chunk] = npt
    return vals


def build_cos_data(I1: torch.Tensor, VV: torch.Tensor, lambdad: float, epsn: float,
                   box, A: int = 96, B: int = 16, patch: int = 1,
                   window_rg: int = 0) -> CosData:
    """Precompute the per-pixel cosine coefficient field (once per run).

    Samples the node potential at the (A, B) midpoint grid over the
    displacement box (:func:`_sample_surface`), then takes a type-II DCT
    along both displacement axes. For ``patch > 1`` the expansion is of the
    patch-summed potential on the ``(Mo, No) / patch`` flow lattice
    (``gqmap_gpuSuper_mix_entropy.m:94-105``); for ``window_rg > 0`` of the
    window-meaned potential (:func:`_box_mean`).
    """
    dtype, device = I1.dtype, I1.device
    lo_u, hi_u, lo_v, hi_v = (float(x) for x in box)
    # midpoint sample positions: x_j = lo + (j + 1/2) L / P
    us = lo_u + (np.arange(A) + 0.5) * (hi_u - lo_u) / A
    vs = lo_v + (np.arange(B) + 0.5) * (hi_v - lo_v) / B
    vals = _sample_surface(I1, VV, lambdad, epsn, us, vs, patch, window_rg)
    M, N = vals.shape[-2:]
    Du = torch.as_tensor(_dct2_matrix(A), dtype=dtype, device=device)
    Dv = torch.as_tensor(_dct2_matrix(B), dtype=dtype, device=device)
    with no_tf32():
        coeffs = torch.matmul(Du, vals.reshape(A, B * M * N)).reshape(A, B, M * N)
        del vals
        coeffs = torch.matmul(Dv, coeffs).reshape(A, B, M, N)
    return CosData(coeffs=coeffs, lo_u=lo_u, hi_u=hi_u, lo_v=lo_v, hi_v=hi_v)


def _mode_sums(cos: CosData, u1, u2, o1, o2, p, want_grads: bool = True):
    """The six mode sums over the (A, B) mode lattice (plain version of K1),
    or with ``want_grads=False`` the first alone, ``(E0,)``.

    All include the coefficient field:
      E0 = sum c (W-C- + W+C+)          A1 = sum c a (W-S- + W+S+)
      A2 = sum c b (W-S- - W+S+)        Aa = sum c a^2 (W-C- + W+C+)
      Ab = sum c b^2 (W-C- + W+C+)      Ax = sum c ab (W-C- - W+C+)
    with C∓/S∓ = cos/sin(a ph1 ∓ b ph2) from rotation recurrences. The
    v-degree axis is evaluated as one batch per u-degree.
    """
    coeffs = cos.coeffs
    A, B = coeffs.shape[:2]
    ku = math.pi / (cos.hi_u - cos.lo_u)
    kv = math.pi / (cos.hi_v - cos.lo_v)
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    ph1 = (ku * (u1 - cos.lo_u)).expand(site)
    ph2 = (kv * (u2 - cos.lo_v)).expand(site)
    s1 = (ku * o1).expand(site)
    s2 = (kv * o2).expand(site)
    p = p.expand(site)
    gm = s1 * s2 * (1.0 - p)   # >= 0
    gp = s1 * s2 * (1.0 + p)   # >= 0
    c1, sn1 = torch.cos(ph1), torch.sin(ph1)
    c2, sn2 = torch.cos(ph2), torch.sin(ph2)

    # cos/sin(b*ph2) for every b, stacked on a leading v-degree axis
    cb, sb = [torch.ones_like(ph2)], [torch.zeros_like(ph2)]
    for _ in range(1, B):
        cb, sb = cb + [cb[-1] * c2 - sb[-1] * sn2], sb + [sb[-1] * c2 + cb[-1] * sn2]
    cb, sb = torch.stack(cb), torch.stack(sb)
    bshape = (B,) + (1,) * len(site)
    bf = torch.arange(B, dtype=ph1.dtype, device=ph1.device).reshape(bshape)
    bs2 = bf * s2
    cshape = (B,) + (1,) * (len(site) - 2) + tuple(coeffs.shape[2:])

    ca, sa = torch.ones_like(ph1), torch.zeros_like(ph1)
    E0, A1, A2, Aa, Ab, Ax = (torch.zeros_like(ph1) for _ in range(6))
    for a in range(A):
        cab = coeffs[a].reshape(cshape)
        m = a * s1 - bs2
        h = -0.5 * (m * m)
        Wm = torch.exp(h - bf * (a * gm))
        Wp = torch.exp(h - bf * (a * gp))
        cacb = ca * cb
        sasb = sa * sb
        U = Wm * (cacb + sasb)    # W- C-
        V = Wp * (cacb - sasb)    # W+ C+
        UV = cab * (U + V)
        sE = UV.sum(0)
        E0 = E0 + sE
        if want_grads:
            sacb = sa * cb
            casb = ca * sb
            Pt = Wm * (sacb - casb)   # W- S-
            Qt = Wp * (sacb + casb)   # W+ S+
            A1 = A1 + a * (cab * (Pt + Qt)).sum(0)
            A2 = A2 + (bf * cab * (Pt - Qt)).sum(0)
            Aa = Aa + (a * a) * sE
            Ab = Ab + (bf * bf * UV).sum(0)
            Ax = Ax + a * (bf * cab * (U - V)).sum(0)
        ca, sa = ca * c1 - sa * sn1, sa * c1 + ca * sn1
    if not want_grads:
        return (E0,)
    return E0, A1, A2, Aa, Ab, Ax


def cos_ei(cos: CosData, u1, u2, o1, o2, p) -> torch.Tensor:
    """Closed-form E[npot] under the correlated bivariate Gaussian (the exact
    expectation of the truncated cosine surface); differentiable, for the
    autodiff estimator."""
    (E0,) = _mode_sums(cos, u1, u2, o1, o2, p, want_grads=False)
    return 0.5 * E0


def _finalize_mode_sums(cos: CosData, sums, u1, o1, o2, p, a, T,
                        entropy_scale: float) -> GQGrads:
    """Turn the six mode sums into finalized gradients (shared by the plain
    path and kernel K1)."""
    E0, A1, A2, Aa, Ab, Ax = sums
    ku = math.pi / (cos.hi_u - cos.lo_u)
    kv = math.pi / (cos.hi_v - cos.lo_v)
    s1 = ku * o1
    s2 = kv * o2
    Ef = 0.5 * E0
    dEdu1 = -0.5 * ku * A1
    dEdu2 = 0.5 * kv * A2
    dEdo1 = 0.5 * ku * (s2 * p * Ax - s1 * Aa)
    dEdo2 = 0.5 * kv * (s1 * p * Ax - s2 * Ab)
    dEdp = 0.5 * s1 * s2 * Ax
    return finalize_closed(Ef, dEdu1, dEdu2, dEdo1, dEdo2, dEdp, a, o1, o2, p, T,
                           entropy_scale)


def cos_node_grads(cos: CosData, u1, u2, o1, o2, p, a, T,
                   entropy_scale: float) -> GQGrads:
    """Expected node potential and its five exact parameter gradients,
    finalized with the alpha weighting and Bethe-entropy terms (plain path)."""
    sums = _mode_sums(cos, u1, u2, o1, o2, p)
    return _finalize_mode_sums(cos, sums, u1, o1, o2, p, a, T, entropy_scale)
