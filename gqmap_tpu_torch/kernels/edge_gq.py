"""Kernel K3: tensor-rule (K^2-point) Charbonnier edge quadrature, on the card.

Counterpart of ``gqmap_tpu/kernels/edge_gq.py`` (``edge_gq_pallas``). The
CUDA kernel is ``gqmap_tpu_torch/csrc/edge_gq.cu``; its plain PyTorch version
is :func:`edge_gq_torch` (``gq_accumulate`` on the Charbonnier edge
potential).

* :func:`edge_gq_cuda` launches the kernel (and raises for tensors that are
  not on a CUDA device); ``edge_gq_cuda.launches`` counts its launches.
* :func:`edge_gq` launches the kernel for CUDA tensors and runs the plain
  version for CPU tensors.

All three take ``mu``/``sg``, the ``(C, L, M, N)`` state stacks (endpoint 1
of edge plane ``dc`` is plane ``dc % C``), and ``u2e``/``o2e``/``rou``, the
``(D, C, L, M, N)`` neighbour stacks, and return the raw sums as
:class:`GQRaw` with ``(D, C, L, M, N)`` fields; ``finalize`` is the caller's,
as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.gq import GQRaw, gq_accumulate
from ..ops.potentials import make_edge_pot
from ..ops.quadrature import build_table
from . import build

__all__ = ["edge_gq", "edge_gq_cuda", "edge_gq_torch", "pack_table"]


def pack_table(K: int, dtype=np.float32) -> np.ndarray:
    """(6, K^2) table: xi, xj, wiwj, xixj, x2a, x2m rows (:func:`build_table`
    in one chunk)."""
    return np.stack(build_table(K, 0, dtype))[:, 0]


def edge_gq_torch(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float) -> GQRaw:
    """Plain version of K3: ``gq_accumulate`` over the whole K^2 rule."""
    return gq_accumulate(make_edge_pot(lambdas, epsn), mu[None], u2e, sg[None], o2e, rou,
                         build_table(K, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def _packed(K: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`pack_table` on the device, made once per (K, dtype, device)."""
    return torch.as_tensor(pack_table(K, np.float64), dtype=dtype, device=device)


def edge_gq_cuda(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float) -> GQRaw:
    """Kernel K3."""
    if mu.device.type != "cuda":
        raise RuntimeError(f"edge_gq_cuda needs CUDA tensors, got {mu.device}")
    if mu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edge_gq_cuda takes float32 or float64, not {mu.dtype}")
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    edge = (D, C, L, M, N)
    for name, x, shape in (("mu", mu, mu.shape), ("sg", sg, mu.shape), ("u2e", u2e, edge),
                           ("o2e", o2e, edge), ("rou", rou, edge)):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.device != mu.device or x.dtype != mu.dtype:
            raise ValueError(f"{name} must share mu's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    tab = _packed(int(K), mu.dtype, mu.device)
    out = torch.empty((6, D * C, L, M, N), dtype=mu.dtype, device=mu.device)
    lib = build.load_library()
    fn = lib.gqmap_edge_gq_f32 if mu.dtype == torch.float32 else lib.gqmap_edge_gq_f64
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    build.check(fn(mu.data_ptr(), sg.data_ptr(), u2e.data_ptr(), o2e.data_ptr(),
                   rou.data_ptr(), tab.data_ptr(), out.data_ptr(), D * C, C, L, M * N,
                   int(K) * int(K), float(lambdas), float(epsn), mu.device.index, stream),
                "edge_gq_cuda")
    edge_gq_cuda.launches += 1
    return GQRaw(*out.reshape((6,) + edge).unbind(0))


edge_gq_cuda.launches = 0


def edge_gq(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float) -> GQRaw:
    """Kernel K3 for CUDA tensors, its plain version for CPU tensors."""
    fn = edge_gq_torch if mu.device.type == "cpu" else edge_gq_cuda
    return fn(mu, sg, u2e, o2e, rou, K, lambdas, epsn)
