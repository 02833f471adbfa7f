"""Gauss-Hermite rules (numpy/scipy; a copy of ``gqmap_tpu/ops/quadrature.py``).

Nodes and weights of the order-K rule by the Golub-Welsch algorithm: the
eigendecomposition of the symmetric tridiagonal Jacobi matrix with
off-diagonal ``sqrt(i/2)`` (``GaussHermite_2.m:21-32``): the 1-D table of
the reduced edge quadrature and the K^2-point tensor-product table of the
exact path, mirroring the ``meshgrid`` constants of
``gqmap_gpu_mixture.m:9-10`` (XI, XJ, WIWJ, XIXJ, XI^2+XJ^2, XI^2-XJ^2),
padded to a chunk multiple with zero-weight points, which add nothing to
any sum. :func:`table_on` holds a table's device copy, made once, so a sweep
copies nothing from the host (a CUDA graph capture refuses such copies).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import scipy.linalg
import torch

__all__ = ["gauss_hermite", "QuadTable", "QuadTable1D", "build_table", "build_table_1d",
           "table_on"]


@functools.lru_cache(maxsize=None)
def _gauss_hermite_cached(n: int):
    if n < 2:
        raise ValueError(f"Gauss-Hermite order must be >= 2, got {n}")
    off = np.sqrt(np.arange(1, n, dtype=np.float64) / 2.0)
    evals, evecs = scipy.linalg.eigh_tridiagonal(np.zeros(n), off)
    x = evals
    w = np.sqrt(np.pi) * evecs[0, :] ** 2
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w


def gauss_hermite(n: int):
    """Nodes and weights of the order-``n`` Gauss-Hermite rule (float64).

    Weight function ``exp(-x^2)`` on (-inf, inf); ``sum(w) == sqrt(pi)``.
    """
    return _gauss_hermite_cached(int(n))


class QuadTable(NamedTuple):
    """Flattened 2-D tensor-product table, chunked. Every field has shape
    ``(steps, chunk)``; the trailing pad (if ``K^2 % chunk != 0``) has
    ``wiwj == 0``."""

    xi: np.ndarray    # XI values (node coordinate along axis 1)
    xj: np.ndarray    # XJ values (node coordinate along axis 2)
    wiwj: np.ndarray  # product weight WI*WJ
    xixj: np.ndarray  # XI*XJ
    x2a: np.ndarray   # XI^2 + XJ^2
    x2m: np.ndarray   # XI^2 - XJ^2

    @property
    def steps(self) -> int:
        return self.xi.shape[0]

    @property
    def chunk(self) -> int:
        return self.xi.shape[1]


class QuadTable1D(NamedTuple):
    """Chunked 1-D Gauss-Hermite table. Fields have shape ``(steps, chunk)``;
    trailing pad points have ``w == 0``."""

    x: np.ndarray
    w: np.ndarray

    @property
    def steps(self) -> int:
        return self.x.shape[0]


def build_table_1d(K: int, chunk: int = 0, dtype=np.float32) -> QuadTable1D:
    """Chunked 1-D K-point Gauss-Hermite table (weight ``exp(-x^2)``)."""
    x, w = gauss_hermite(K)
    if chunk <= 0 or chunk > K:
        chunk = K
    steps = -(-K // chunk)
    pad = steps * chunk - K

    def prep(a):
        return np.pad(a, (0, pad)).reshape(steps, chunk).astype(dtype)

    return QuadTable1D(x=prep(x), w=prep(w))


def build_table(K: int, chunk: int = 0, dtype=np.float32) -> QuadTable:
    """Chunked K^2-point tensor-product table; ``chunk`` points per step,
    0 for all K^2 in one step."""
    x, w = gauss_hermite(K)
    K2 = K * K
    # MATLAB meshgrid(X): XI(r,c) = X(c), XJ(r,c) = X(r); the flat order is
    # irrelevant because every use is a full sum over the K^2 points.
    xi = np.tile(x[None, :], (K, 1)).reshape(-1)
    xj = np.tile(x[:, None], (1, K)).reshape(-1)
    wi = np.tile(w[None, :], (K, 1)).reshape(-1)
    wj = np.tile(w[:, None], (1, K)).reshape(-1)
    if chunk <= 0 or chunk > K2:
        chunk = K2
    steps = -(-K2 // chunk)
    pad = steps * chunk - K2

    def prep(a):
        return np.pad(a, (0, pad)).reshape(steps, chunk).astype(dtype)

    return QuadTable(xi=prep(xi), xj=prep(xj), wiwj=prep(wi * wj), xixj=prep(xi * xj),
                     x2a=prep(xi**2 + xj**2), x2m=prep(xi**2 - xj**2))


@functools.lru_cache(maxsize=None)
def table_on(K: int, chunk: int, one_d: bool, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """``np.stack`` of the float64 ``build_table(K, chunk)`` (``build_table_1d``
    if ``one_d``) as a ``dtype`` tensor on ``device``: ``(fields, steps,
    chunk)``, fields in the table's order. Made once for its arguments, as the
    kernel wrappers' rule tables are, so a sum of :mod:`.gq` given it copies
    nothing from the host. The tensor is shared: callers read it and never
    write it."""
    tab = (build_table_1d if one_d else build_table)(K, chunk, np.float64)
    return torch.as_tensor(np.stack(tab), dtype=dtype, device=device)
