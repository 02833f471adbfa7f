"""Gauss-Hermite rules (numpy/scipy; a copy of ``gqmap_tpu/ops/quadrature.py``).

Nodes and weights of the order-K rule by the Golub-Welsch algorithm: the
eigendecomposition of the symmetric tridiagonal Jacobi matrix with
off-diagonal ``sqrt(i/2)`` (``GaussHermite_2.m:21-32``). Only the 1-D table
of the reduced edge quadrature is on the port's main path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import scipy.linalg

__all__ = ["gauss_hermite", "QuadTable1D", "build_table_1d"]


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
