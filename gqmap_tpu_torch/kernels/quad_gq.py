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
Two variants (:data:`VARIANTS`; ``variant=None`` runs
:func:`resolve_variant`'s choice). ``"v1"`` sums the plain version's table
point by point (:func:`rule_values`: its K nodes and each point's weighted
monomials): K = 9, ``legacy_v1``'s, is compiled into an instance of its own
with the rule passed by value; any other K (or ``generic=True``) runs the
generic instance, which reads it from the card. ``"v2"``, the default, uses
that both integrands are quadratics in the rule's abscissae: each sum is
:func:`closed_form_table`'s fixed linear map of the quadratic's six
coefficients. K10 v2 is that map a site, for every K. K11 v2 classifies
each edge element by a bound on its samples' differences: every sample
inside the cutoff (the closed form), every one beyond it (zeros), or
"mixed", which alone runs a point loop (:func:`node_values`: rows of
column sums) in one of two forms that give the same bits (a warp's lanes
each on its own element, or a half warp on one element; :data:`COOP_LANES`
picks). K11 forms each sample's difference ``d = x2 - x1`` as the plain
version does on the card, each operation rounded once in its order, so the
cutoff ``|d| > dta`` puts every sample on the plain version's side of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gq import GQRaw, gq_accumulate
from ..ops.potentials import make_edge_pot_truncquad, make_node_pot_quadratic
from ..ops.quadrature import build_table, gauss_hermite, table_on
from . import build

__all__ = ["CLASS_COUNTS", "COOP_LANES", "SPECIALISED", "V2_MAX_K", "VARIANTS",
           "closed_form_table", "node_values", "quad_node_gq", "quad_node_gq_cuda",
           "quad_node_gq_torch", "resolve_variant", "rule_values", "table_of", "takes",
           "truncquad_edge_gq", "truncquad_edge_gq_cuda", "truncquad_edge_gq_torch",
           "unit_rule"]

SPECIALISED = (9,)  # rules compiled into their own instance (csrc/quad_gq.cu)
VARIANTS = ("v1", "v2")
_DEFAULT_VARIANT = "v2"
V2_MAX_K = 32  # K11 v2 holds the nodes by value (csrc/quad_gq.cu kMaxK); K10 v2 any K
# K11 v2: the mixed lanes a warp up to which the cooperative form runs (more
# run the per-lane form; 0 never cooperates, 32 always), read at each launch
COOP_LANES = 8
# K11 v2's counters (``counts=``): edge elements of each class, warps with a
# mixed lane, and of those the ones that ran the cooperative form and their
# mixed elements
CLASS_COUNTS = ("inside", "outside", "mixed", "mixed warps", "cooperative warps",
                "cooperative elements")


def takes(kernel: str, K: int, dtype: torch.dtype) -> bool:
    """Whether ``kernel`` ("K10" or "K11") computes its term for a K-point
    rule: K10 v2 any K (its closed forms); K11 from 2 points an axis (its
    instances), in v2 up to :data:`V2_MAX_K`, beyond it in v1, whose
    generic instance stages ``K + 4 K^2`` values into shared memory
    (``build.rule_fits``: K <= 55 in float32, K <= 39 in float64)."""
    K = int(K)
    if kernel == "K10":
        return K >= 1
    return K >= 2 and (K <= V2_MAX_K or build.rule_fits(K + 4 * K * K, dtype))


def resolve_variant(variant: str | None, K: int, kernel: str = "K10") -> str:
    """The variant a launch of ``kernel`` ("K10" or "K11") runs: ``variant``,
    or with None ``_DEFAULT_VARIANT`` where it takes the rule (K11 v2 takes
    at most :data:`V2_MAX_K` nodes) and ``"v1"`` elsewhere; an explicit
    variant that does not take the rule raises."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown quad_gq kernel variant {variant!r}")
    takes_v2 = kernel == "K10" or int(K) <= V2_MAX_K
    if variant is None:
        return _DEFAULT_VARIANT if takes_v2 else "v1"
    if variant == "v2" and not takes_v2:
        raise ValueError(f"{kernel} v2 takes rules of at most {V2_MAX_K} nodes, not K = {K}")
    return variant


def table_of(sums: np.ndarray, xi: np.ndarray, xj: np.ndarray) -> np.ndarray:
    """The closed form's ``(6, 6)`` table of a rule: ``sums[i]`` is each
    point's weight times sum monomial i (Ei, Zc, Zr, Sa, Sm, Sxy: 1, XI, XJ,
    XI^2 + XJ^2 - 1, XI^2 - XJ^2, XI XJ), ``xi``, ``xj`` its abscissae;
    ``T[i][j]`` sums ``sums[i]`` times coefficient monomial j (1, XI, XJ,
    XI^2, XI XJ, XJ^2), in float64."""
    xi, xj = np.asarray(xi, np.float64), np.asarray(xj, np.float64)
    coef = np.stack([np.ones_like(xi), xi, xj, xi * xi, xi * xj, xj * xj])
    return np.asarray(sums, np.float64) @ coef.T


def closed_form_table(K: int, dtype=np.float64) -> np.ndarray:
    """v2's ``(6, 6)`` table T of the K^2-point rule (:func:`table_of` on
    ``build_table(K)``'s own points and weights in float64, rounded to
    ``dtype``): a quadratic g with coefficients c on (1, XI, XJ, XI^2, XI XJ,
    XJ^2) has the rule's raw sums (Ei, Zc, Zr, Sa, Sm, Sxy of ``-g``, before
    Z1, Z2 and the scale) ``T c``."""
    tab = build_table(K, 0, np.float64)
    xi, xj, w = tab.xi.reshape(-1), tab.xj.reshape(-1), tab.wiwj.reshape(-1)
    sums = np.stack([w, w * xi, w * xj, w * (tab.x2a.reshape(-1) - 1.0),
                     w * tab.x2m.reshape(-1), w * tab.xixj.reshape(-1)])
    return table_of(sums, xi, xj).astype(dtype)


def node_values(K: int, dtype=np.float64) -> np.ndarray:
    """The ``5 K`` node values K11 v2's point loop reads: the nodes x
    (rounded to ``dtype``, the plain table's XI and XJ), then the weights w,
    ``w x``, ``w x^2`` and ``w (x^2 - 1)`` (in float64, rounded). A row r's
    column sums take w_c, w_c x_c and w_c x_c^2; its terms w_r, w_r x_r,
    w_r x_r^2 and w_r (x_r^2 - 1)."""
    x, w = gauss_hermite(K)
    return np.concatenate([x, w, w * x, w * x * x, w * (x * x - 1.0)]).astype(dtype)


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


def unit_rule(K: int) -> dict:
    """The K^2-point rule with unit weights and no monomials, as each variant
    reads it: replacements for :func:`rule_values` (v1),
    :func:`closed_form_table` and :func:`node_values` (v2), by name. Patched
    in, Ei is the sum of the potential over the samples, the other sums 0,
    so a sample on the other side of K11's cutoff shows in Ei alone."""
    unit = rule_values(K)
    unit[K:] = 0.0
    unit[K:K + K * K] = 1.0
    x = gauss_hermite(K)[0]
    sums = np.zeros((6, K * K))
    sums[0] = 1.0
    table = table_of(sums, np.tile(x, K), np.repeat(x, K))
    nodes = np.concatenate([x, np.ones(K), np.zeros(3 * K)])
    return {name: (lambda K, dtype=np.float64, v=v: v.astype(dtype)) for name, v in (
        ("rule_values", unit), ("closed_form_table", table), ("node_values", nodes))}


def quad_node_gq_torch(prior, muu, muv, su, sv, pn, K: int, var: float,
                       quad_chunk: int = 0) -> GQRaw:
    """Plain version of K10: ``gq_accumulate`` of the quadratic prior over the
    K^2 rule, ``quad_chunk`` points a step."""
    return gq_accumulate(make_node_pot_quadratic(prior, var), muu, muv, su, sv, pn,
                         table_on(K, quad_chunk, False, muu.dtype, muu.device))


def quad_node_gq_cuda(prior, muu, muv, su, sv, pn, K: int, var: float,
                      generic: bool = False, variant: str | None = None) -> GQRaw:
    """Kernel K10. v1: the instance compiled for K if K is in
    :data:`SPECIALISED` and ``generic`` is false, else the generic
    instance; v2 (one instance for every K, ``generic`` moot): the closed
    form a site."""
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
    variant = resolve_variant(variant, K, "K10")
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    f32 = muu.dtype == torch.float32
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    sm, sn, sc = prior.stride()
    if max(abs(sm) * M, abs(sn) * N, abs(sc)) >= 2 ** 31:
        raise ValueError(f"the prior's strides {prior.stride()} exceed the kernel's int range")
    ptrs = (muu.data_ptr(), muv.data_ptr(), su.data_ptr(), sv.data_ptr(), pn.data_ptr(),
            prior.data_ptr())
    scale = -1.0 / (2.0 * var)
    if variant == "v2":
        # `table` holds what the launch copies into its parameters
        table = build._rule_host(closed_form_table, K, muu.dtype)
        fn = lib.gqmap_quad_node_gq_v2_f32 if f32 else lib.gqmap_quad_node_gq_v2_f64
        code = fn(*ptrs, table.ctypes.data, out.data_ptr(), L, M, N, sm, sn, sc, scale,
                  muu.device.index, stream)
    else:
        # `rule` holds what rule_host or rule_dev points at through the launch
        rule, rule_host, rule_dev = build.rule_args(rule_values, K, SPECIALISED, generic, muu)
        fn = lib.gqmap_quad_node_gq_f32 if f32 else lib.gqmap_quad_node_gq_f64
        code = fn(*ptrs, rule_host, rule_dev, out.data_ptr(), L, M, N, K, sm, sn, sc, scale,
                  muu.device.index, stream)
    build.check(code, "quad_node_gq_cuda")
    quad_node_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


quad_node_gq_cuda.launches = 0


def quad_node_gq(prior, muu, muv, su, sv, pn, K: int, var: float,
                 quad_chunk: int = 0, variant: str | None = None) -> GQRaw:
    """Kernel K10 for CUDA tensors (``variant``), its plain version
    (``quad_chunk`` points a step) for CPU tensors."""
    if muu.device.type == "cpu":
        return quad_node_gq_torch(prior, muu, muv, su, sv, pn, K, var, quad_chunk=quad_chunk)
    return quad_node_gq_cuda(prior, muu, muv, su, sv, pn, K, var, variant=variant)


def truncquad_edge_gq_torch(mu, sg, u2e, o2e, rou, K: int, gama: float, dta: float,
                            quad_chunk: int = 0) -> GQRaw:
    """Plain version of K11: ``gq_accumulate`` of the truncated-quadratic edge
    potential over the K^2 rule, ``quad_chunk`` points a step."""
    return gq_accumulate(make_edge_pot_truncquad(gama, dta), mu[None], u2e, sg[None], o2e, rou,
                         table_on(K, quad_chunk, False, mu.dtype, mu.device))


def truncquad_edge_gq_cuda(mu, sg, u2e, o2e, rou, K: int, gama: float, dta: float,
                           generic: bool = False, variant: str | None = None,
                           counts: torch.Tensor | None = None) -> GQRaw:
    """Kernel K11: the instance compiled for K if K is in :data:`SPECIALISED`
    and ``generic`` is false, else the generic (v2: runtime-K) instance.
    v2 only: ``counts``, an int64 tensor of 6 on the card, gains
    :data:`CLASS_COUNTS`; at most :data:`COOP_LANES` mixed lanes a warp run
    the cooperative form."""
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    edge = (D, C, L, M, N)
    build.check_operands("truncquad_edge_gq_cuda", mu, (
        ("mu", mu, mu.shape), ("sg", sg, mu.shape), ("u2e", u2e, edge), ("o2e", o2e, edge),
        ("rou", rou, edge)))
    K = int(K)
    variant = resolve_variant(variant, K, "K11")
    if variant == "v1" and counts is not None:
        raise ValueError("counts are K11 v2's")
    n_counts = len(CLASS_COUNTS)
    if counts is not None and (counts.dtype != torch.int64 or tuple(counts.shape) != (n_counts,)
                               or counts.device != mu.device or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int64 tensor of {n_counts} on the "
                         "state's device")
    out = torch.empty((6, D * C, L, M, N), dtype=mu.dtype, device=mu.device)
    lib = build.library_for(mu.device)
    f32 = mu.dtype == torch.float32
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    ptrs = (mu.data_ptr(), sg.data_ptr(), u2e.data_ptr(), o2e.data_ptr(), rou.data_ptr())
    scale = -1.0 / (2.0 * gama)
    if variant == "v2":
        # `table` and `nodes` hold what the launch copies into its parameters
        table = build._rule_host(closed_form_table, K, mu.dtype)
        nodes = build._rule_host(node_values, K, mu.dtype)
        fn = lib.gqmap_truncquad_edge_gq_v2_f32 if f32 else lib.gqmap_truncquad_edge_gq_v2_f64
        code = fn(*ptrs, table.ctypes.data, nodes.ctypes.data, out.data_ptr(),
                  None if counts is None else counts.data_ptr(), D * C, C, L, M * N, K,
                  int(generic), int(COOP_LANES), float(dta), scale, mu.device.index, stream)
    else:
        # `rule` holds what rule_host or rule_dev points at through the launch
        rule, rule_host, rule_dev = build.rule_args(rule_values, K, SPECIALISED, generic, mu)
        fn = lib.gqmap_truncquad_edge_gq_f32 if f32 else lib.gqmap_truncquad_edge_gq_f64
        code = fn(*ptrs, rule_host, rule_dev, out.data_ptr(), D * C, C, L, M * N, K,
                  float(dta), scale, mu.device.index, stream)
    build.check(code, "truncquad_edge_gq_cuda")
    truncquad_edge_gq_cuda.launches += 1
    return GQRaw(*out.reshape((6,) + edge).unbind(0))


truncquad_edge_gq_cuda.launches = 0


def truncquad_edge_gq(mu, sg, u2e, o2e, rou, K: int, gama: float, dta: float,
                      quad_chunk: int = 0, variant: str | None = None) -> GQRaw:
    """Kernel K11 for CUDA tensors (``variant``), its plain version
    (``quad_chunk`` points a step) for CPU tensors."""
    if mu.device.type == "cpu":
        return truncquad_edge_gq_torch(mu, sg, u2e, o2e, rou, K, gama, dta,
                                       quad_chunk=quad_chunk)
    return truncquad_edge_gq_cuda(mu, sg, u2e, o2e, rou, K, gama, dta, variant=variant)
