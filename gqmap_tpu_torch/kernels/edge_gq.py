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

The kernel pairs each point of the rule with its mirror image
(:func:`paired_rule`). For K in :data:`SPECIALISED` it runs an instance
compiled for that rule, with the coefficients passed by value; for any
other K (or with ``generic=True``) the generic instance, which reads them
from a table on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gq import GQRaw, gq_accumulate
from ..ops.potentials import make_edge_pot
from ..ops.quadrature import gauss_hermite, table_on
from . import build

__all__ = ["SPECIALISED", "edge_gq", "edge_gq_cuda", "edge_gq_torch", "pair_order",
           "paired_rule", "takes"]

SPECIALISED = (9, 11)  # rules compiled into their own instance (csrc/edge_gq.cu)


def takes(K: int, dtype: torch.dtype) -> bool:
    """Whether K3 computes the edges for a K-point rule: at least 2 points
    an axis (``rule_instance.cuh``), and :func:`paired_rule`'s ``8 P + 1``
    values in the generic instance's shared memory (``build.rule_fits``:
    K <= 55 in float32, K <= 39 in float64)."""
    K = int(K)
    return K >= 2 and build.rule_fits(8 * (K * K // 2) + 1, dtype)


def pair_order(K: int) -> np.ndarray:
    """The order of the kernel's ``K^2 // 2`` pairs, each named by the flat
    index ``j K + i`` of its first point (XI = x_i, XJ = x_j; the mirror is
    ``K^2 - 1`` minus it): in flat order, each pair followed by its transpose
    partner, the pair of the point (x_j, x_i), unless the pair is its own.
    The two have opposite XI^2 - XJ^2 weights, so the Sm accumulator gains
    their difference, which is small near the |rho| clamp, where XI and XJ
    enter d almost alike; in flat order its partial sums grow to many times
    the result and float32 accumulation doubles Sm's error there."""
    P = K * K // 2
    order, placed = [], set()
    for k in range(P):
        if k in placed:
            continue
        kt = (k % K) * K + k // K
        kt = min(kt, K * K - 1 - kt)  # the pair holding the transposed point
        for x in (k, kt):
            if x not in placed:
                order.append(x)
                placed.add(x)
    return np.array(order)


def paired_rule(K: int, dtype=np.float64) -> np.ndarray:
    """The K^2-point rule as the kernel reads it: ``8 P + 1`` values for the
    ``P = K^2 // 2`` pairs of a point and its mirror, in :func:`pair_order`,
    row by row: XI, XJ of the pair's first point, then WIWJ times 1, XI, XJ,
    XI XJ, XI^2 + XJ^2 - 1 and XI^2 - XJ^2; last the centre point's weight
    (odd K; 0 for even K). Nodes and weights are symmetrised,
    ``x_k = -x_{K-1-k}`` and ``w_k = w_{K-1-k}``, which the Golub-Welsch
    values satisfy to rounding."""
    x, w = gauss_hermite(K)
    x = 0.5 * (x - x[::-1])
    w = 0.5 * (w + w[::-1])
    k = pair_order(K)
    xi, xj = x[k % K], x[k // K]
    wiwj = w[k % K] * w[k // K]
    wc = w[K // 2] ** 2 if K % 2 else 0.0
    rows = [xi, xj, wiwj, wiwj * xi, wiwj * xj, wiwj * xi * xj,
            wiwj * (xi * xi + xj * xj - 1.0), wiwj * (xi * xi - xj * xj)]
    return np.concatenate(rows + [[wc]]).astype(dtype)


def edge_gq_torch(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float) -> GQRaw:
    """Plain version of K3: ``gq_accumulate`` over the whole K^2 rule."""
    return gq_accumulate(make_edge_pot(lambdas, epsn), mu[None], u2e, sg[None], o2e, rou,
                         table_on(K, 0, False, mu.dtype, mu.device))


def edge_gq_cuda(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float,
                 generic: bool = False) -> GQRaw:
    """Kernel K3: the instance compiled for K if K is in :data:`SPECIALISED`
    and ``generic`` is false, else the generic instance."""
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    edge = (D, C, L, M, N)
    build.check_operands("edge_gq_cuda", mu, (("mu", mu, mu.shape), ("sg", sg, mu.shape),
                                              ("u2e", u2e, edge), ("o2e", o2e, edge),
                                              ("rou", rou, edge)))
    K = int(K)
    # `rule` holds what rule_host or rule_dev points at through the launch
    rule, rule_host, rule_dev = build.rule_args(paired_rule, K, SPECIALISED, generic, mu)
    out = torch.empty((6, D * C, L, M, N), dtype=mu.dtype, device=mu.device)
    lib = build.library_for(mu.device)
    fn = lib.gqmap_edge_gq_f32 if mu.dtype == torch.float32 else lib.gqmap_edge_gq_f64
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    build.check(fn(mu.data_ptr(), sg.data_ptr(), u2e.data_ptr(), o2e.data_ptr(),
                   rou.data_ptr(), rule_host, rule_dev, out.data_ptr(), D * C, C, L, M * N,
                   K, float(lambdas), float(epsn), mu.device.index, stream),
                "edge_gq_cuda")
    edge_gq_cuda.launches += 1
    return GQRaw(*out.reshape((6,) + edge).unbind(0))


edge_gq_cuda.launches = 0


def edge_gq(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float) -> GQRaw:
    """Kernel K3 for CUDA tensors, its plain version for CPU tensors."""
    fn = edge_gq_torch if mu.device.type == "cpu" else edge_gq_cuda
    return fn(mu, sg, u2e, o2e, rou, K, lambdas, epsn)
