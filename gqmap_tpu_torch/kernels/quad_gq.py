"""Kernels K10 and K11: the legacy quadratic family's tensor-rule quadrature, on the card.

The JAX package has no Pallas kernel for either: it runs an XLA scan of
``gq_accumulate`` (``gqmap_tpu/ops/gq.py:93``) on
``make_node_pot_quadratic`` (``gqmap_tpu/ops/potentials.py:321``, the node
prior toward ``Problem.init_flow``) and on ``make_edge_pot_truncquad``
(``:296``, the truncated-quadratic edges), the node and edge terms of
``GQMAPConfig.legacy_v1``. The CUDA kernels are
``gqmap_tpu_torch/csrc/quad_gq.cu``; their plain PyTorch versions are
:func:`quad_node_gq_torch` and :func:`truncquad_edge_gq_torch`,
``gq_accumulate`` on the port's potentials.

* :func:`quad_node_gq_cuda` (K10) takes the prior ``(M, N, 2)`` (any strides:
  a shard's block is a view) and the ``(L, M, N)`` site fields;
* :func:`truncquad_edge_gq_cuda` (K11) takes K3's arguments
  (``kernels/edge_gq.py``): ``mu``/``sg``, the ``(C, L, M, N)`` state stacks,
  and ``u2e``/``o2e``/``rou``, the ``(D, C, L, M, N)`` neighbour stacks;
* :func:`quad_node_gq` and :func:`truncquad_edge_gq` launch the kernel for
  CUDA tensors and run the plain version (``quad_chunk`` points a step) for
  CPU tensors.

Each returns the raw sums as :class:`GQRaw`; ``finalize`` is the caller's.
The rule is the plain version's table (:func:`rule_values`: its K nodes and
each point's weighted monomials): K = 9, ``legacy_v1``'s, is compiled into
an instance of its own with the rule passed by value; any other K (or
``generic=True``) runs the generic instance, which reads it from the card.
K11 forms each sample's difference ``d = x2 - x1`` as the plain version
does on the card, each operation rounded once in its order, so the cutoff
``|d| > dta`` puts every sample on the plain version's side of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gq import GQRaw, gq_accumulate
from ..ops.potentials import make_edge_pot_truncquad, make_node_pot_quadratic
from ..ops.quadrature import build_table, gauss_hermite, table_on
from . import build

__all__ = ["SPECIALISED", "quad_node_gq", "quad_node_gq_cuda", "quad_node_gq_torch",
           "rule_values", "truncquad_edge_gq", "truncquad_edge_gq_cuda",
           "truncquad_edge_gq_torch"]

SPECIALISED = (9,)  # rules compiled into their own instance (csrc/quad_gq.cu)


def rule_values(K: int, dtype=np.float64) -> np.ndarray:
    """The ``K + 4 K^2`` values of the rule the kernels read: the K nodes x
    (the point ``r K + c`` of ``build_table(K)`` has XI = x_c and XJ = x_r),
    rounded to ``dtype`` as the plain version's table is, then at every point,
    in the table's order, WIWJ (the table's, rounded to ``dtype``) and WIWJ
    times XI XJ, XI^2 + XJ^2 - 1 and XI^2 - XJ^2 (in float64, rounded)."""
    tab = build_table(K, 0, np.float64)
    w = tab.wiwj.reshape(-1)
    rows = [gauss_hermite(K)[0], w, w * tab.xixj.reshape(-1), w * (tab.x2a.reshape(-1) - 1.0),
            w * tab.x2m.reshape(-1)]
    return np.concatenate(rows).astype(dtype)


def quad_node_gq_torch(prior, muu, muv, su, sv, pn, K: int, var: float,
                       quad_chunk: int = 0) -> GQRaw:
    """Plain version of K10: ``gq_accumulate`` of the quadratic prior over the
    K^2 rule, ``quad_chunk`` points a step."""
    return gq_accumulate(make_node_pot_quadratic(prior, var), muu, muv, su, sv, pn,
                         table_on(K, quad_chunk, False, muu.dtype, muu.device))


def quad_node_gq_cuda(prior, muu, muv, su, sv, pn, K: int, var: float,
                      generic: bool = False) -> GQRaw:
    """Kernel K10: the instance compiled for K if K is in :data:`SPECIALISED`
    and ``generic`` is false, else the generic instance."""
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    L, M, N = muu.shape
    build.check_operands("quad_node_gq_cuda", muu, ((name, x, (L, M, N)) for name, x in (
        ("muu", muu), ("muv", muv), ("su", su), ("sv", sv), ("pn", pn))))
    if tuple(prior.shape) != (M, N, 2):
        raise ValueError(f"prior has shape {tuple(prior.shape)}, expected {(M, N, 2)}")
    if prior.device != muu.device or prior.dtype != muu.dtype:
        raise ValueError("prior must share muu's device and dtype")
    K = int(K)
    # `rule` holds what rule_host or rule_dev points at through the launch
    rule, rule_host, rule_dev = build.rule_args(rule_values, K, SPECIALISED, generic, muu)
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    fn = lib.gqmap_quad_node_gq_f32 if muu.dtype == torch.float32 else lib.gqmap_quad_node_gq_f64
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    sm, sn, sc = prior.stride()
    if max(abs(sm) * M, abs(sn) * N, abs(sc)) >= 2 ** 31:
        raise ValueError(f"the prior's strides {prior.stride()} exceed the kernel's int range")
    build.check(fn(muu.data_ptr(), muv.data_ptr(), su.data_ptr(), sv.data_ptr(), pn.data_ptr(),
                   prior.data_ptr(), rule_host, rule_dev, out.data_ptr(), L, M, N, K, sm, sn, sc,
                   -1.0 / (2.0 * var), muu.device.index, stream),
                "quad_node_gq_cuda")
    quad_node_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


quad_node_gq_cuda.launches = 0


def quad_node_gq(prior, muu, muv, su, sv, pn, K: int, var: float,
                 quad_chunk: int = 0) -> GQRaw:
    """Kernel K10 for CUDA tensors, its plain version (``quad_chunk`` points
    a step) for CPU tensors."""
    if muu.device.type == "cpu":
        return quad_node_gq_torch(prior, muu, muv, su, sv, pn, K, var, quad_chunk=quad_chunk)
    return quad_node_gq_cuda(prior, muu, muv, su, sv, pn, K, var)


def truncquad_edge_gq_torch(mu, sg, u2e, o2e, rou, K: int, gama: float, dta: float,
                            quad_chunk: int = 0) -> GQRaw:
    """Plain version of K11: ``gq_accumulate`` of the truncated-quadratic edge
    potential over the K^2 rule, ``quad_chunk`` points a step."""
    return gq_accumulate(make_edge_pot_truncquad(gama, dta), mu[None], u2e, sg[None], o2e, rou,
                         table_on(K, quad_chunk, False, mu.dtype, mu.device))


def truncquad_edge_gq_cuda(mu, sg, u2e, o2e, rou, K: int, gama: float, dta: float,
                           generic: bool = False) -> GQRaw:
    """Kernel K11: the instance compiled for K if K is in :data:`SPECIALISED`
    and ``generic`` is false, else the generic instance."""
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    edge = (D, C, L, M, N)
    build.check_operands("truncquad_edge_gq_cuda", mu, (
        ("mu", mu, mu.shape), ("sg", sg, mu.shape), ("u2e", u2e, edge), ("o2e", o2e, edge),
        ("rou", rou, edge)))
    K = int(K)
    # `rule` holds what rule_host or rule_dev points at through the launch
    rule, rule_host, rule_dev = build.rule_args(rule_values, K, SPECIALISED, generic, mu)
    out = torch.empty((6, D * C, L, M, N), dtype=mu.dtype, device=mu.device)
    lib = build.library_for(mu.device)
    fn = (lib.gqmap_truncquad_edge_gq_f32 if mu.dtype == torch.float32
          else lib.gqmap_truncquad_edge_gq_f64)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    build.check(fn(mu.data_ptr(), sg.data_ptr(), u2e.data_ptr(), o2e.data_ptr(), rou.data_ptr(),
                   rule_host, rule_dev, out.data_ptr(), D * C, C, L, M * N, K, float(dta),
                   -1.0 / (2.0 * gama), mu.device.index, stream),
                "truncquad_edge_gq_cuda")
    truncquad_edge_gq_cuda.launches += 1
    return GQRaw(*out.reshape((6,) + edge).unbind(0))


truncquad_edge_gq_cuda.launches = 0


def truncquad_edge_gq(mu, sg, u2e, o2e, rou, K: int, gama: float, dta: float,
                      quad_chunk: int = 0) -> GQRaw:
    """Kernel K11 for CUDA tensors, its plain version (``quad_chunk`` points
    a step) for CPU tensors."""
    if mu.device.type == "cpu":
        return truncquad_edge_gq_torch(mu, sg, u2e, o2e, rou, K, gama, dta,
                                       quad_chunk=quad_chunk)
    return truncquad_edge_gq_cuda(mu, sg, u2e, o2e, rou, K, gama, dta)
