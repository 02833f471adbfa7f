"""Kernel K5: tensor-rule (K^2-point) node quadrature of the Chebyshev data term, on the card.

The node term of ``data_term="chebyshev"``: ``gq_accumulate`` over
``make_node_pot_chebyshev``, which the JAX package runs as one XLA scan
(``gqmap_tpu/ops/gq.py:93`` on ``gqmap_tpu/ops/chebyshev.py:126``, called at
``gqmap_tpu/models/gqmap.py:487``) and no Pallas kernel. The CUDA kernel is
``gqmap_tpu_torch/csrc/cheb_gq.cu`` (its notes say how it is laid out); its
plain PyTorch version is :func:`cheb_gq_torch`, exactly what the sweep ran
before the kernel.

* :func:`cheb_gq_cuda` launches the kernel (and raises for tensors that are
  not on a CUDA device); ``cheb_gq_cuda.launches`` counts its launches.
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

__all__ = ["MAX_K", "MAX_Q", "cheb_gq", "cheb_gq_cuda", "cheb_gq_torch", "lanes", "q_width",
           "site_blocks"]

MAX_K = 64  # the largest rule the kernel takes (csrc/cheb_gq.cu, kMaxK)
MAX_Q = 64  # the largest v-degree count: a sample's basis stays in registers (kMaxQ)
_MAX_SMEM_BYTES = 47 * 1024  # csrc/cheb_gq.cu kMaxDynSmem


def q_width(Q: int) -> int:
    """The instance that runs ``Q`` v-degrees: its row width in shared
    memory, 8, 16, 32 or 64 (the columns past ``Q`` hold zeros)."""
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"cheb_gq takes 1 to {MAX_Q} v-degrees, not {Q}")
    return next(w for w in (8, 16, 32, 64) if Q <= w)


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


def cheb_gq_cuda(cheb: ChebData, muu, muv, su, sv, pn, K: int) -> GQRaw:
    """Kernel K5 over every point of the K^2 rule."""
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
    # one site a CTA needs its L K^2 sample values, one row and the rule
    need = (L * K * K + q_width(Q)) * muu.element_size() + 2 * K * 8
    if need > _MAX_SMEM_BYTES:
        raise ValueError(f"cheb_gq_cuda: L = {L} components of a K = {K} rule need {need} bytes "
                         f"of shared memory a site, over {_MAX_SMEM_BYTES}")
    cu, ru = (cheb.lo_u + cheb.hi_u) * 0.5, (cheb.hi_u - cheb.lo_u) * 0.5
    cv, rv = (cheb.lo_v + cheb.hi_v) * 0.5, (cheb.hi_v - cheb.lo_v) * 0.5
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    fn = lib.gqmap_cheb_gq_f32 if muu.dtype == torch.float32 else lib.gqmap_cheb_gq_f64
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    build.check(fn(coeffs.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                   sv.data_ptr(), pn.data_ptr(), _rule_host(K).ctypes.data,
                   out.data_ptr(), L, M * N, P, Q, K, float(cu), float(ru), float(cv), float(rv),
                   muu.device.index, stream),
                "cheb_gq_cuda")
    cheb_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


cheb_gq_cuda.launches = 0


def cheb_gq(cheb: ChebData, muu, muv, su, sv, pn, K: int, quad_chunk: int = 0) -> GQRaw:
    """Kernel K5 for CUDA tensors, its plain version (``quad_chunk`` points a
    step) for CPU tensors."""
    if muu.device.type == "cpu":
        return cheb_gq_torch(cheb, muu, muv, su, sv, pn, K, quad_chunk=quad_chunk)
    return cheb_gq_cuda(cheb, muu, muv, su, sv, pn, K)
