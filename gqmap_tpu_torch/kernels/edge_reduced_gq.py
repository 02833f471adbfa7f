"""Kernel K2: fused reduced-1D edge gradients, on the card.

Counterpart of ``gqmap_tpu/kernels/edge_reduced_gq.py``
(``edge_reduced_grads_pallas``). The CUDA kernel is
``gqmap_tpu_torch/csrc/edge_reduced_gq.cu``; its plain PyTorch version is
:func:`edge_reduced_grads_torch` (``gq_accumulate_diff`` + ``finalize``).

* :func:`edge_reduced_grads_cuda` launches the kernel (and raises for tensors
  that are not on a CUDA device); ``edge_reduced_grads_cuda.launches`` counts
  its launches.
* :func:`edge_reduced_grads` launches the kernel for CUDA tensors and runs
  the plain version for CPU tensors.

All three take the JAX function's interface: ``mu``/``sg`` are the
``(C, L, M, N)`` state stacks (endpoint 1 of edge plane ``dc`` is plane
``dc % C``), ``u2e``/``o2e``/``rou`` the ``(D, C, L, M, N)`` neighbour stacks,
``alpha`` the ``(L,)`` mixture weights and ``T`` the temperature; they return
:class:`GQGrads` with ``(D, C, L, M, N)`` fields.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.gq import GQGrads, finalize, gq_accumulate_diff
from ..ops.potentials import make_edge_pot_diff
from ..ops.quadrature import build_table_1d, gauss_hermite
from . import build

__all__ = ["edge_reduced_grads", "edge_reduced_grads_cuda", "edge_reduced_grads_torch"]


def edge_reduced_grads_torch(mu, sg, u2e, o2e, rou, alpha, T, k1: int, lambdas: float,
                             epsn: float, entropy_scale: float) -> GQGrads:
    """Plain version of K2: ``gq_accumulate_diff`` + ``finalize``."""
    L = mu.shape[1]
    raw = gq_accumulate_diff(make_edge_pot_diff(lambdas, epsn), mu[None], u2e, sg[None],
                             o2e, rou, build_table_1d(k1, dtype=np.float64))
    return finalize(raw, alpha.reshape(L, 1, 1), sg[None], o2e, rou, T, entropy_scale)


@functools.lru_cache(maxsize=None)
def _gh_table(k1: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(2, K1) nodes and weights on the device, made once per (K1, dtype, device)."""
    x, w = gauss_hermite(k1)
    return torch.as_tensor(np.stack([x, w]), dtype=dtype, device=device)


def edge_reduced_grads_cuda(mu, sg, u2e, o2e, rou, alpha, T, k1: int, lambdas: float,
                            epsn: float, entropy_scale: float) -> GQGrads:
    """Kernel K2. ``alpha`` and ``T`` must be tensors on the card: the kernel
    reads them through device pointers."""
    if mu.device.type != "cuda":
        raise RuntimeError(f"edge_reduced_grads_cuda needs CUDA tensors, got {mu.device}")
    if mu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edge_reduced_grads_cuda takes float32 or float64, not {mu.dtype}")
    if not isinstance(T, torch.Tensor) or not isinstance(alpha, torch.Tensor):
        raise TypeError("alpha and T must be tensors on the card")
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    edge = (D, C, L, M, N)
    for name, x, shape in (("mu", mu, mu.shape), ("sg", sg, mu.shape), ("u2e", u2e, edge),
                           ("o2e", o2e, edge), ("rou", rou, edge), ("alpha", alpha, (L,)),
                           ("T", T, ())):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.device != mu.device or x.dtype != mu.dtype:
            raise ValueError(f"{name} must share mu's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    tab = _gh_table(int(k1), mu.dtype, mu.device)
    out = torch.empty((6, D * C, L, M, N), dtype=mu.dtype, device=mu.device)
    lib = build.load_library()
    fn = lib.gqmap_edge_reduced_f32 if mu.dtype == torch.float32 else lib.gqmap_edge_reduced_f64
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    build.check(fn(mu.data_ptr(), sg.data_ptr(), u2e.data_ptr(), o2e.data_ptr(),
                   rou.data_ptr(), alpha.data_ptr(), T.data_ptr(), tab.data_ptr(),
                   out.data_ptr(), D * C, C, L, M * N, int(k1), float(lambdas),
                   float(epsn), float(entropy_scale), mu.device.index, stream),
                "edge_reduced_grads_cuda")
    edge_reduced_grads_cuda.launches += 1
    da, du1, du2, do1, do2, dp = out.reshape((6,) + edge).unbind(0)
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp,
                   E=alpha.reshape(1, 1, L, 1, 1) * da)


edge_reduced_grads_cuda.launches = 0


def edge_reduced_grads(mu, sg, u2e, o2e, rou, alpha, T, k1: int, lambdas: float,
                       epsn: float, entropy_scale: float) -> GQGrads:
    """Kernel K2 for CUDA tensors, its plain version for CPU tensors."""
    fn = edge_reduced_grads_torch if mu.device.type == "cpu" else edge_reduced_grads_cuda
    return fn(mu, sg, u2e, o2e, rou, alpha, T, k1, lambdas, epsn, entropy_scale)
