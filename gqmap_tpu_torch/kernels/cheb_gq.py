"""Kernel K5: tensor-rule (K^2-point) node quadrature of the Chebyshev data term, on the card.

The node term of ``data_term="chebyshev"``: ``gq_accumulate`` over
``make_node_pot_chebyshev``, which the JAX package runs as one XLA scan
(``gqmap_tpu/ops/gq.py:93`` on ``gqmap_tpu/ops/chebyshev.py:126``, called at
``gqmap_tpu/models/gqmap.py:487``) and no Pallas kernel. The CUDA kernel is
``gqmap_tpu_torch/csrc/cheb_gq.cu`` (its notes say how it is laid out); its
plain PyTorch version is :func:`cheb_gq_torch`, exactly what the sweep ran
before the kernel. Two variants (:data:`VARIANTS`): ``"v1"``, a site's lanes
over its samples with the series on the FMA pipe, and ``"v2"`` (the default
where it takes the shape, :func:`resolve_variant`), float32 only: a site's
(samples x Q) . (Q x P) product on the tensor cores as 3xTF32 ``wgmma``,
the blocks brought into shared memory by bulk asynchronous copies, half a
CTA's warps on the products and half on the rest, a stage apart. float64 runs
``"v1"``. The two differ at rounding only.

* :func:`cheb_gq_cuda` launches the kernel (and raises for tensors that are
  not on a CUDA device); ``cheb_gq_cuda.launches`` counts its launches, of
  either variant.
* :func:`cheb_gq` launches the kernel for CUDA tensors and runs the plain
  version for CPU tensors.

All three take the coefficient field ``cheb`` (:class:`..ops.chebyshev.ChebData`,
``(P, Q, M, N)`` stored site major, as ``build_cheb_data`` and a shard's
``site_major`` block store it) and the ``(L, M, N)`` state ``muu, muv, su,
sv, pn``, and return the raw sums as :class:`GQRaw` with ``(L, M, N)``
fields; ``finalize`` is the caller's. The plain version and :func:`cheb_gq`
also take ``quad_chunk``, the plain version's points a step (0: all); the
kernel takes every point of the rule in one pass.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.chebyshev import ChebData, make_node_pot_chebyshev
from ..ops.gq import GQRaw, gq_accumulate
from ..ops.quadrature import table_on
from . import build
from .node_gq import node_rule

__all__ = ["MAX_K", "MAX_Q", "V2_MAX_K", "V2_MAX_L", "V2_MAX_Q", "VARIANTS", "cheb_gq",
           "cheb_gq_cuda", "cheb_gq_torch", "lanes", "q_width", "resolve_variant", "site_blocks",
           "takes", "v1_smem", "v2_layout"]

MAX_K = 64  # the largest rule the kernel takes (csrc/cheb_gq.cu, kMaxK)
MAX_Q = 64  # the largest v-degree count: a sample's basis stays in registers (kMaxQ)
VARIANTS = ("v1", "v2")  # kernel codes 0, 1
_DEFAULT_VARIANT = "v2"
_MAX_SMEM_BYTES = 47 * 1024  # csrc/cheb_gq.cu kMaxDynSmem ("v1")
_V2_SMEM_BYTES = 227 * 1024  # csrc/cheb_gq.cu kV2MaxSmem: one CTA an SM
V2_MAX_Q = 32  # the most v-degrees of "v2" (its instances: widths 8, 16, 32)
V2_MAX_K = 16  # the largest rule of "v2" (its point table in shared memory; kV2MaxK)
V2_MAX_L = 32  # the most components of "v2" (a thread a stage's (site, component); kV2MaxL)


def q_width(Q: int) -> int:
    """The instance that runs ``Q`` v-degrees: its row width in shared
    memory, 8, 16, 32 or 64 (the columns past ``Q`` hold zeros)."""
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"cheb_gq takes 1 to {MAX_Q} v-degrees, not {Q}")
    return next(w for w in (8, 16, 32, 64) if Q <= w)


def v1_smem(L: int, K: int, Q: int, dtype: torch.dtype) -> int:
    """The shared memory one site a CTA needs: its ``L K^2`` sample values,
    one row of the field and the rule (at most ``_MAX_SMEM_BYTES``)."""
    itemsize = 4 if dtype == torch.float32 else 8
    return (L * K * K + q_width(Q)) * itemsize + 2 * K * 8


def takes(K: int, Q: int, L: int, dtype: torch.dtype) -> bool:
    """Whether K5 computes the term for a K-point rule, ``Q`` v-degrees and
    ``L`` components: at most :data:`MAX_K` points an axis and :data:`MAX_Q`
    v-degrees, one site's :func:`v1_smem` within a CTA's shared memory."""
    K, Q, L = int(K), int(Q), int(L)
    return (1 <= K <= MAX_K and 1 <= Q <= MAX_Q and L >= 1
            and v1_smem(L, K, Q, dtype) <= _MAX_SMEM_BYTES)


def lanes(L: int, K: int, Q: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """A launch's ``(R, G, rounds)``: samples a lane a round (by the
    instance: 4, 4, 2, 1 at widths 8, 16, 32, 64 in float32, 2, 2, 1, 1 in
    float64), lanes a site (whole warps, at most 256) and rounds, for a
    site's ``L K^2`` samples (csrc/cheb_gq.cu, launch_instance)."""
    R = {8: 4, 16: 4, 32: 2, 64: 1}[q_width(Q)]
    if dtype == torch.float64:
        R = max(1, R // 2)
    need = -(-L * K * K // R)
    G = min(256, 32 * -(-need // 32))
    return R, G, -(-L * K * K // (G * R))


def v2_layout(L: int, K: int, P: int, Q: int) -> dict:
    """``"v2"``'s launch for ``L`` components of the K^2 rule on a ``(P, Q)``
    field (csrc/cheb_gq.cu, launch_v2): a site's ``units`` of 64 samples
    (one a warpgroup's wgmma rows), its ``samples`` padded to whole units;
    one site a stage, a ring of ``stages`` raw blocks (3, or 2 where 3 do not
    fit), ``chunks`` of ``width`` u-degrees (a wgmma's columns: 32, 64 or 96,
    the fewest that hold P, 96 past it) and ``k_steps`` of 8 v-degrees;
    ``smem`` the CTA's bytes of shared memory (one CTA an SM, two stage
    buffers) and ``fits`` whether that fits the budget and the shape the
    instances (at most :data:`V2_MAX_Q` v-degrees, :data:`V2_MAX_K` points an
    axis, :data:`V2_MAX_L` components)."""
    QB = q_width(Q)
    width = next((w for w in (32, 64) if P <= w), 96)
    KS, NC = QB // 8, -(-P // width)
    U = -(-L * K * K // 64)
    NSP = 64 * U

    def round128(n):
        return -(-n // 128) * 128

    def smem(stages):
        buf = round128(64 + 32 * K * K + 256 * L + stages * P * Q * 4)
        return buf + 2 * round128(NC * KS * width * 64 + NC * width * 4 + 16
                                  + NSP * (4 * QB + 72))

    stages = 3 if smem(3) <= _V2_SMEM_BYTES else 2
    return dict(units=U, samples=NSP, stages=stages, width=width, chunks=NC, k_steps=KS,
                smem=smem(stages),
                fits=(smem(stages) <= _V2_SMEM_BYTES and Q <= V2_MAX_Q and K <= V2_MAX_K
                      and L <= V2_MAX_L))


def resolve_variant(variant: str | None, dtype: torch.dtype, L: int, K: int, P: int, Q: int,
                    aligned: bool = True) -> str:
    """The variant a launch runs: ``variant``, or with None ``"v2"`` where it
    takes the shape and ``"v1"`` elsewhere. ``"v2"`` takes float32, ``P Q``
    a multiple of 4 on a field whose first element is 16-byte aligned
    (``aligned``: every site's block is then a run of whole 16-byte units,
    as the bulk copy moves them), a stage within its shared memory, at most
    :data:`V2_MAX_Q` v-degrees, :data:`V2_MAX_K` points an axis and
    :data:`V2_MAX_L` components (:func:`v2_layout`); float64 is
    ``"v1"``'s. An explicit ``"v2"``
    outside that raises."""
    takes = (dtype == torch.float32 and (P * Q) % 4 == 0 and aligned
             and v2_layout(L, K, P, Q)["fits"])
    if variant is None:
        return _DEFAULT_VARIANT if takes else "v1"
    if variant not in VARIANTS:
        raise ValueError(f"unknown cheb_gq kernel variant {variant!r}")
    if variant == "v2" and not takes:
        raise ValueError(f"cheb_gq variant 'v2' takes float32, P Q a multiple of 4 on a 16-byte "
                         f"aligned field, a stage within {_V2_SMEM_BYTES} bytes, Q <= {V2_MAX_Q}, "
                         f"K <= {V2_MAX_K} and L <= {V2_MAX_L}, not {dtype}, {P} x {Q}, L = {L}, "
                         f"K = {K}, aligned {aligned}")
    return variant


def site_blocks(coeffs: torch.Tensor) -> torch.Tensor:
    """The ``(M N, P, Q)`` view of a site-major ``(P, Q, M, N)`` field, each
    site's block one contiguous matrix; raises for any other layout (a copy
    would move the whole field, 1-2 GB at 376 x 452, every sweep)."""
    if coeffs.ndim != 4:
        raise ValueError(f"the coefficient field must be (P, Q, M, N), got {tuple(coeffs.shape)}")
    P, Q, M, N = coeffs.shape
    cs = coeffs.permute(2, 3, 0, 1)
    if not cs.is_contiguous():
        raise ValueError(
            f"the coefficient field (strides {coeffs.stride()}) is not stored site major: "
            "build it with ops.chebyshev.build_cheb_data or pass ops.chebyshev.site_major(...)")
    return cs.reshape(M * N, P, Q)


def cheb_gq_torch(cheb: ChebData, muu, muv, su, sv, pn, K: int, quad_chunk: int = 0) -> GQRaw:
    """Plain version of K5: ``gq_accumulate`` of the Chebyshev series over
    the K^2 rule, ``quad_chunk`` points a step."""
    return gq_accumulate(make_node_pot_chebyshev(cheb), muu, muv, su, sv, pn,
                         table_on(K, quad_chunk, False, muu.dtype, muu.device))


@functools.lru_cache(maxsize=None)
def _rule_host(K: int) -> np.ndarray:
    """:func:`.node_gq.node_rule` in float64 on the host, copied into the
    launch's parameters in both types (the kernel forms a point's constants
    in double and rounds them once, as the plain table holds them); kept
    alive by the cache."""
    return np.ascontiguousarray(node_rule(K, np.float64))


def cheb_gq_cuda(cheb: ChebData, muu, muv, su, sv, pn, K: int,
                 variant: str | None = None) -> GQRaw:
    """Kernel K5 over every point of the K^2 rule; ``variant`` one of
    :data:`VARIANTS` (None: :func:`resolve_variant`)."""
    if muu.device.type != "cuda":
        raise RuntimeError(f"cheb_gq_cuda needs CUDA tensors, got {muu.device}")
    if muu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cheb_gq_cuda takes float32 or float64, not {muu.dtype}")
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    coeffs = cheb.coeffs
    site_blocks(coeffs)
    P, Q = coeffs.shape[:2]
    L, M, N = muu.shape
    if tuple(coeffs.shape[2:]) != (M, N):
        raise ValueError(f"the coefficient field's lattice {tuple(coeffs.shape[2:])} is not the "
                         f"state's ({M}, {N})")
    for name, x in (("coeffs", coeffs), ("muu", muu), ("muv", muv), ("su", su), ("sv", sv),
                    ("pn", pn)):
        if x.device != muu.device or x.dtype != muu.dtype:
            raise ValueError(f"{name} must share muu's device and dtype")
        if name != "coeffs" and (tuple(x.shape) != (L, M, N) or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (L, M, N) = {(L, M, N)} tensor, got "
                             f"{tuple(x.shape)}")
    K = int(K)
    if not 1 <= K <= MAX_K:
        raise ValueError(f"cheb_gq_cuda takes rules of 1 to {MAX_K} points an axis, not {K}")
    need = v1_smem(L, K, Q, muu.dtype)
    if need > _MAX_SMEM_BYTES:
        raise ValueError(f"cheb_gq_cuda: L = {L} components of a K = {K} rule need {need} bytes "
                         f"of shared memory a site, over {_MAX_SMEM_BYTES}")
    code = VARIANTS.index(resolve_variant(variant, muu.dtype, L, K, P, Q,
                                          coeffs.data_ptr() % 16 == 0))
    cu, ru = (cheb.lo_u + cheb.hi_u) * 0.5, (cheb.hi_u - cheb.lo_u) * 0.5
    cv, rv = (cheb.lo_v + cheb.hi_v) * 0.5, (cheb.hi_v - cheb.lo_v) * 0.5
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    fn = lib.gqmap_cheb_gq_f32 if muu.dtype == torch.float32 else lib.gqmap_cheb_gq_f64
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    build.check(fn(coeffs.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                   sv.data_ptr(), pn.data_ptr(), _rule_host(K).ctypes.data,
                   out.data_ptr(), L, M * N, P, Q, K, code, float(cu), float(ru), float(cv),
                   float(rv), muu.device.index, stream),
                "cheb_gq_cuda")
    cheb_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


cheb_gq_cuda.launches = 0


def cheb_gq(cheb: ChebData, muu, muv, su, sv, pn, K: int, quad_chunk: int = 0) -> GQRaw:
    """Kernel K5 (its default variant) for CUDA tensors, its plain version
    (``quad_chunk`` points a step) for CPU tensors."""
    if muu.device.type == "cpu":
        return cheb_gq_torch(cheb, muu, muv, su, sv, pn, K, quad_chunk=quad_chunk)
    return cheb_gq_cuda(cheb, muu, muv, su, sv, pn, K)
