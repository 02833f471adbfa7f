"""Gather-free spectral (Chebyshev) data term, ``data_term="chebyshev"``.

Port of ``gqmap_tpu/ops/chebyshev.py``. Per pixel, the displacement-cost
surface ``npot(u, v) = -lambda_d sqrt(eps + (I1 - I2^b(i+v, j+u))^2)`` is
expanded in a tensor-product Chebyshev basis over a displacement box: the
expansion nodes are global displacements, so each node value is a
constant-offset bicubic sample of frame 2 (``ops/cosine._sample_surface``),
and the coefficients come from a type-II DCT (two matrix products). A
quadrature sample then costs a P x Q polynomial evaluation and no gather.

The JAX package evaluates the series in XLA, with no Pallas kernel. Here
:func:`make_node_pot_chebyshev` is the plain torch version: per site, the
samples' u-basis ``T_a(u')`` (an ``(S, P)`` matrix) times the site's
``(P, Q)`` coefficient block in one batched product over the sites, then a
row-wise dot with the v-basis; under the Stein estimator on the card the
sweep runs the node quadrature over it as kernel K5
(:mod:`gqmap_tpu_torch.kernels.cheb_gq`). The coefficient field keeps the
JAX shape ``(P, Q, M, N)`` but is stored site major, so each site's block
is one contiguous matrix of that product and one run the kernel reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .cosine import _dct2_matrix as _dct_matrix
from .cosine import _sample_surface, no_tf32
from .interp import clip

__all__ = ["ChebData", "build_cheb_data", "make_node_pot_chebyshev"]

# Elements of one site chunk's u-basis in make_node_pot_chebyshev: bounds its
# temporaries (the basis twice, the batched product) to a few GB in float32.
_EVAL_CHUNK_ELEMS = 1 << 28


class ChebData(NamedTuple):
    coeffs: torch.Tensor  # (P, Q, M, N) Chebyshev coefficients of npot, site major
    lo_u: float           # displacement box bounds
    hi_u: float
    lo_v: float
    hi_v: float


def _cheb_nodes(P: int) -> np.ndarray:
    """First-kind Chebyshev nodes on [-1, 1], k = 0..P-1."""
    return np.cos(np.pi * (np.arange(P) + 0.5) / P)


def site_major(coeffs: torch.Tensor) -> torch.Tensor:
    """``coeffs`` (P, Q, M, N) with the same values, stored as (M, N, P, Q)."""
    return coeffs.permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)


def build_cheb_data(I1: torch.Tensor, VV: torch.Tensor, lambdad: float, epsn: float, box,
                    P: int = 64, Q: int = 64, patch: int = 1, window_rg: int = 0) -> ChebData:
    """Precompute the per-pixel coefficient field (once per run).

    ``box = (lo_u, hi_u, lo_v, hi_v)`` in pixels. The surface is sampled at
    the (P, Q) first-kind Chebyshev nodes of the box; for ``patch > 1`` it
    is the patch-summed node potential on the flow lattice
    (``gqmap_gpuSuper_mix_entropy.m:94-105``), for ``window_rg > 0`` the
    window-meaned one (``legacy/gqmap_cpuV2.m:29-33``), so neither costs
    anything at sweep time.
    """
    dtype, device = I1.dtype, I1.device
    lo_u, hi_u, lo_v, hi_v = (float(x) for x in box)
    us = (lo_u + hi_u) / 2.0 + (hi_u - lo_u) / 2.0 * _cheb_nodes(P)
    vs = (lo_v + hi_v) / 2.0 + (hi_v - lo_v) / 2.0 * _cheb_nodes(Q)
    vals = _sample_surface(I1, VV, lambdad, epsn, us, vs, patch, window_rg)
    M, N = vals.shape[-2:]
    Du = torch.as_tensor(_dct_matrix(P), dtype=dtype, device=device)
    Dv = torch.as_tensor(_dct_matrix(Q), dtype=dtype, device=device)
    with no_tf32():
        # (a, q, site) = Du (a, p) @ vals (p, q site)
        half = torch.matmul(Du, vals.reshape(P, Q * M * N)).reshape(P, Q, M * N)
        del vals
        # (site, a, b) = half (site, a, q) @ Dv^T (q, b): the site-major field
        coeffs = torch.matmul(half.permute(2, 0, 1), Dv.T)
    return ChebData(coeffs=coeffs.reshape(M, N, P, Q).permute(2, 3, 0, 1),
                    lo_u=lo_u, hi_u=hi_u, lo_v=lo_v, hi_v=hi_v)


def _basis(x: torch.Tensor, n: int) -> torch.Tensor:
    """``T_0 .. T_{n-1}`` at ``x`` by the three-term recurrence, stacked on a
    new leading axis."""
    T = [torch.ones_like(x), x]
    two_x = 2.0 * x
    for _ in range(2, n):
        T.append(two_x * T[-1] - T[-2])
    return torch.stack(T[:n])


def make_node_pot_chebyshev(cheb: ChebData, a_block: int = 8):
    """Return ``f(x1, x2)`` evaluating the spectral data term.

    Inputs have shape ``lead + (M, N)`` (displacement samples); each is
    clipped to the box and the tensor series summed at it. ``a_block`` is
    the JAX scan's block of u-degrees and changes no value; here the sites
    go in chunks of at most ``_EVAL_CHUNK_ELEMS`` u-basis elements.
    """
    del a_block
    P, Q, M, N = cheb.coeffs.shape
    # (sites, P, Q): a view of the site-major field build_cheb_data returns
    cs = cheb.coeffs.permute(2, 3, 0, 1).reshape(M * N, P, Q)
    cu, ru = (cheb.lo_u + cheb.hi_u) * 0.5, (cheb.hi_u - cheb.lo_u) * 0.5
    cv, rv = (cheb.lo_v + cheb.hi_v) * 0.5, (cheb.hi_v - cheb.lo_v) * 0.5

    def f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        up = clip((x1 - cu) / ru, -1.0, 1.0)
        vp = clip((x2 - cv) / rv, -1.0, 1.0)
        up, vp = torch.broadcast_tensors(up, vp)
        lead = up.shape[:-2]
        S = math.prod(lead)
        up, vp = up.reshape(S, M * N), vp.reshape(S, M * N)
        step = max(1, _EVAL_CHUNK_ELEMS // (S * P))
        parts = []
        with no_tf32():
            for j in range(0, M * N, step):
                # the bases as (degree, site, sample): their (site, sample,
                # degree) views are matrices with unit row stride per site
                Tu = _basis(up[:, j:j + step].T.contiguous(), P)
                Tv = _basis(vp[:, j:j + step].T.contiguous(), Q)
                G = torch.bmm(Tu.permute(1, 2, 0), cs[j:j + step])  # (site, S, Q)
                parts.append((G * Tv.permute(1, 2, 0)).sum(-1).T)
        return torch.cat(parts, 1).reshape(lead + (M, N))

    return f
