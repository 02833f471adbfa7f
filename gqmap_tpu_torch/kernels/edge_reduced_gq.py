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

All three take ``mu``/``sg``, the ``(C, L, M, N)`` state stacks, ``rou``, the
``(2, C, L, M, N)`` edge correlations, ``alpha`` the ``(L,)`` mixture weights
and ``T`` the temperature, and return :class:`GQGrads` with
``(2, C, L, M, N)`` fields (the kernel's ``E`` None). Endpoint 1 of an edge is the site, endpoint 2
its neighbour one row down (direction 0) or one column right (direction 1),
with wrap: the JAX function's ``u2e``/``o2e`` stacks, which
:func:`neighbour_stacks` builds and the plain version uses, and which the
kernel reads in place.

On a shard of the lattice the wrap would land on the block's own first row
and column, so each takes an optional ``halo``, ``(down, right)``: the
stacked ``(mu, sg)`` one row below the block, ``(2, C, L, 1, N)``, and one
column to its right, ``(2, C, L, M, 1)`` (``parallel.halo.halo_edges``).
The wrapper then pads ``mu`` and ``sg`` with it to ``(C, L, M + 1, N + 1)``
and ``rou`` with zeros (:func:`pad_halo`), runs the unchanged kernel (or
the plain version) on the padded block and crops ``[..., :M, :N]``: every
cropped site's neighbours are the true ones, and only the padded row and
column, cropped away, read a wrapped value.

The kernel pairs each node of the rule with its mirror image
(:func:`paired_rule_1d`). For K1 in :data:`SPECIALISED` it runs an instance
compiled for that rule, with the coefficients passed by value; for any
other K1 (or with ``generic=True``) the generic instance, which reads them
from a table on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.gq import GQGrads, finalize, gq_accumulate_diff
from ..ops.potentials import make_edge_pot_diff
from ..ops.quadrature import gauss_hermite, table_on
from . import build

__all__ = ["SPECIALISED", "edge_reduced_grads", "edge_reduced_grads_cuda",
           "edge_reduced_grads_torch", "neighbour_stacks", "pad_halo", "paired_rule_1d", "takes"]

SPECIALISED = (21, 25)  # rules compiled into their own instance (csrc/edge_reduced_gq.cu)


def takes(k1: int, dtype: torch.dtype) -> bool:
    """Whether K2 (and K15 v2, on the same rule) computes the edges for a
    K1-point rule: at least 2 points, and :func:`paired_rule_1d`'s ``4 P +
    1`` values in the generic instance's shared memory
    (``build.rule_fits``)."""
    k1 = int(k1)
    return k1 >= 2 and build.rule_fits(4 * (k1 // 2) + 1, dtype)


def neighbour_stacks(mu, sg, roll=torch.roll):
    """Endpoint 2 of every edge, ``(2, C, L, M, N)`` each: the state one row
    down (direction 0) and one column right (direction 1), with wrap.
    ``roll(x, shift, axis)`` is the lattice's roll: ``torch.roll``, or on a
    shard the global roll across shards (one exchange an axis for both
    stacks)."""
    ms = torch.stack([mu, sg])
    down, right = roll(ms, -1, -2), roll(ms, -1, -1)
    return torch.stack([down[0], right[0]]), torch.stack([down[1], right[1]])


def pad_halo(mu, sg, rou, halo):
    """``mu`` and ``sg`` padded to ``(C, L, M + 1, N + 1)`` with the halo's row
    below and column to the right, and ``rou`` padded with zeros. The corner
    is read only by padded sites; it repeats the row's last value, so those
    stay finite."""
    down, right = halo
    ms = torch.stack([mu, sg])
    ms = torch.cat([torch.cat([ms, right], -1), torch.cat([down, down[..., -1:]], -1)], -2)
    return ms[0], ms[1], torch.nn.functional.pad(rou, (0, 1, 0, 1))


def _crop(g: GQGrads, M: int, N: int) -> GQGrads:
    return GQGrads(*(None if x is None else x[..., :M, :N] for x in g))


def paired_rule_1d(k1: int, dtype=np.float64) -> np.ndarray:
    """The K1-point rule as the kernel reads it: ``4 P + 1`` values for the
    ``P = K1 // 2`` pairs of nodes ``+-x``, row by row: ``x > 0``, ``w``,
    ``w x`` and ``w (x^2 - 1/2)``; last the centre node's weight (odd K1; 0
    for even K1). Nodes and weights are symmetrised, ``x_k = -x_{K1-1-k}``
    and ``w_k = w_{K1-1-k}``, which the Golub-Welsch values satisfy to
    rounding."""
    x, w = gauss_hermite(k1)
    x = 0.5 * (x - x[::-1])[::-1][: k1 // 2]  # the positive nodes
    w = 0.5 * (w + w[::-1])
    wc = w[k1 // 2] if k1 % 2 else 0.0
    w = w[: k1 // 2]
    return np.concatenate([x, w, w * x, w * (x * x - 0.5), [wc]]).astype(dtype)


def edge_reduced_grads_torch(mu, sg, rou, alpha, T, k1: int, lambdas: float, epsn: float,
                             entropy_scale: float, halo=None) -> GQGrads:
    """Plain version of K2: ``gq_accumulate_diff`` + ``finalize``; with a
    ``halo``, on the padded block, cropped."""
    if halo is not None:
        M, N = mu.shape[-2:]
        return _crop(edge_reduced_grads_torch(*pad_halo(mu, sg, rou, halo), alpha, T, k1,
                                              lambdas, epsn, entropy_scale), M, N)
    L = mu.shape[1]
    u2e, o2e = neighbour_stacks(mu, sg)
    raw = gq_accumulate_diff(make_edge_pot_diff(lambdas, epsn), mu[None], u2e, sg[None],
                             o2e, rou, table_on(k1, 0, True, mu.dtype, mu.device))
    return finalize(raw, alpha.reshape(L, 1, 1), sg[None], o2e, rou, T, entropy_scale)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@functools.lru_cache(maxsize=None)
def _rule_host(k1: int, dtype: torch.dtype) -> np.ndarray:
    """:func:`paired_rule_1d` on the host, for a specialised instance (copied
    into the launch's parameters); kept alive by the cache."""
    return np.ascontiguousarray(paired_rule_1d(k1, _NP_DTYPES[dtype]))


@functools.lru_cache(maxsize=None)
def _rule_dev(k1: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`paired_rule_1d` on the device, for the generic instance."""
    return torch.as_tensor(paired_rule_1d(k1), dtype=dtype, device=device)


def edge_reduced_grads_cuda(mu, sg, rou, alpha, T, k1: int, lambdas: float, epsn: float,
                            entropy_scale: float, generic: bool = False,
                            halo=None) -> GQGrads:
    """Kernel K2: the instance compiled for K1 if K1 is in
    :data:`SPECIALISED` and ``generic`` is false, else the generic instance.
    ``alpha`` and ``T`` must be tensors on the card: the kernel reads them
    through device pointers. With a ``halo``, one launch on the padded
    block, cropped. The kernel writes the six gradients; ``E`` (``alpha *
    da``, which would be one more launch) is None: its callers form it
    (kernel K8 and ``sweep_update.edge_grads_torch``)."""
    if halo is not None:
        M, N = mu.shape[-2:]
        return _crop(edge_reduced_grads_cuda(*pad_halo(mu, sg, rou, halo), alpha, T, k1,
                                             lambdas, epsn, entropy_scale, generic), M, N)
    if mu.device.type != "cuda":
        raise RuntimeError(f"edge_reduced_grads_cuda needs CUDA tensors, got {mu.device}")
    if mu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edge_reduced_grads_cuda takes float32 or float64, not {mu.dtype}")
    if not isinstance(T, torch.Tensor) or not isinstance(alpha, torch.Tensor):
        raise TypeError("alpha and T must be tensors on the card")
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    edge = (2, C, L, M, N)
    for name, x, shape in (("mu", mu, mu.shape), ("sg", sg, mu.shape), ("rou", rou, edge),
                           ("alpha", alpha, (L,)), ("T", T, ())):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.device != mu.device or x.dtype != mu.dtype:
            raise ValueError(f"{name} must share mu's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    k1 = int(k1)
    if generic or k1 not in SPECIALISED:
        rule_host, rule_dev = None, _rule_dev(k1, mu.dtype, mu.device).data_ptr()
    else:
        rule_host, rule_dev = _rule_host(k1, mu.dtype).ctypes.data, None
    out = torch.empty((6,) + edge, dtype=mu.dtype, device=mu.device)
    lib = build.library_for(mu.device)
    fn = lib.gqmap_edge_reduced_f32 if mu.dtype == torch.float32 else lib.gqmap_edge_reduced_f64
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    build.check(fn(mu.data_ptr(), sg.data_ptr(), rou.data_ptr(), alpha.data_ptr(),
                   T.data_ptr(), rule_host, rule_dev, out.data_ptr(), C, L, M, N, k1,
                   float(lambdas), float(epsn), float(entropy_scale), mu.device.index,
                   stream),
                "edge_reduced_grads_cuda")
    edge_reduced_grads_cuda.launches += 1
    da, du1, du2, do1, do2, dp = out.unbind(0)
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp, E=None)


edge_reduced_grads_cuda.launches = 0


def edge_reduced_grads(mu, sg, rou, alpha, T, k1: int, lambdas: float, epsn: float,
                       entropy_scale: float, halo=None) -> GQGrads:
    """Kernel K2 for CUDA tensors (``E`` None), its plain version for CPU
    tensors."""
    if mu.device.type == "cpu":
        return edge_reduced_grads_torch(mu, sg, rou, alpha, T, k1, lambdas, epsn,
                                        entropy_scale, halo)
    return edge_reduced_grads_cuda(mu, sg, rou, alpha, T, k1, lambdas, epsn, entropy_scale,
                                   halo=halo)
