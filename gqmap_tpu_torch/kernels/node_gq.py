"""Kernel K4: tensor-rule (K^2-point) bicubic Charbonnier node quadrature, on the card.

The exact path's node term: ``gq_accumulate`` over
``make_node_pot_bicubic``, which the JAX package runs as one XLA scan
(``gqmap_tpu/ops/gq.py``, called at ``gqmap_tpu/models/gqmap.py:488``) and
no Pallas kernel. The CUDA kernel is ``gqmap_tpu_torch/csrc/node_gq.cu``; its
plain PyTorch version is :func:`node_gq_torch`, exactly what the sweep ran
before the kernel. Two variants (:data:`VARIANTS`): ``"v1"``, one lane a
(site, pixel) pair sampling each pixel alone, and ``"v2"`` (the default),
the lanes of a site splitting the rule's points, one set of cubic weights
and one ``(patch + 3)^2`` tap window a point, the table window of a CTA in
shared memory (the source's notes say how). ``"v2"`` takes ``patch`` 1 and 4
and rules up to :data:`V2_MAX_K` points an axis; with no ``variant`` other
launches run ``"v1"``. The two differ at rounding only.

* :func:`node_gq_cuda` launches the kernel (and raises for tensors that are
  not on a CUDA device); ``node_gq_cuda.launches`` counts its launches, of
  either variant.
* :func:`node_gq` launches the kernel for CUDA tensors and runs the plain
  version for CPU tensors.

All three take frame 1 ``I1`` (the whole ``(Mo, No)`` frame), ``VV =
pad_cubic(I2)``, the ``(L, M, N)`` state ``muu, muv, su, sv, pn`` on the
flow lattice of ``patch x patch`` pixel blocks, and on a shard the block's
pixel ``origin`` (row, column) and ``local_image_shape`` (as
``make_node_pot_bicubic``), and return the raw sums as :class:`GQRaw` with
``(L, M, N)`` fields; ``finalize`` is the caller's. The plain version and
:func:`node_gq` also take ``quad_chunk``, the plain version's points a step
(0: all); the kernel takes every point of the rule in one pass.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.gq import GQRaw, gq_accumulate
from ..ops.potentials import make_node_pot_bicubic
from ..ops.quadrature import gauss_hermite, table_on
from . import build

__all__ = ["MAX_K", "V2_MAX_K", "V2_PATCHES", "VARIANTS", "node_gq",
           "node_gq_cuda", "node_gq_torch", "group_lanes", "node_rule", "resolve_variant",
           "takes", "v2_tile", "v2_ctas", "window_budget"]

MAX_K = 64  # the largest rule the kernel takes (csrc/node_gq.cu, kMaxK)
V2_MAX_K = 16  # the largest rule of "v2" (its K^2-point table in shared memory)
V2_PATCHES = (1, 4)  # the patches "v2" is compiled for
VARIANTS = ("v1", "v2")  # kernel codes 0, 1
_DEFAULT_VARIANT = "v2"
# "v2": a CTA's shared memory for its rule table and its window of the table,
# by default and at most (csrc/node_gq.cu kMaxDynSmem)
_SMEM_BYTES = 44 * 1024
_MAX_SMEM_BYTES = 47 * 1024


def takes(K: int) -> bool:
    """Whether K4 computes the term for a K-point rule (``"v1"`` at any
    patch; ``"v2"`` where :func:`resolve_variant` picks it)."""
    return 1 <= int(K) <= MAX_K


def node_rule(K: int, dtype=np.float64) -> np.ndarray:
    """The rule as the kernel reads it: the K Gauss-Hermite nodes, then the K
    weights (the values :func:`..ops.quadrature.build_table` multiplies out)."""
    x, w = gauss_hermite(K)
    return np.concatenate([x, w]).astype(dtype)


def group_lanes(patch: int) -> int:
    """The lanes that share a site: the largest power of two not above
    ``min(patch^2, 32)``; lane ``g`` of a group takes the block pixels ``g,
    g + G, ...`` (row major) and the group sums its partial sums by an
    xor-shuffle tree."""
    G = 1
    while G < 32 and 2 * G <= patch * patch:
        G *= 2
    return G


def resolve_variant(variant: str | None, K: int, patch: int) -> str:
    """The variant a launch runs: ``variant``, or with None ``"v2"`` where
    it is compiled (``patch`` in :data:`V2_PATCHES`, ``K`` at most
    :data:`V2_MAX_K`) and ``"v1"`` elsewhere; an explicit ``"v2"`` outside
    that raises."""
    fits = int(patch) in V2_PATCHES and int(K) <= V2_MAX_K
    if variant is None:
        return _DEFAULT_VARIANT if fits else "v1"
    if variant not in VARIANTS:
        raise ValueError(f"unknown node_gq kernel variant {variant!r}")
    if variant == "v2" and not fits:
        raise ValueError(f"node_gq variant 'v2' takes patch in {V2_PATCHES} and rules of at "
                         f"most {V2_MAX_K} points an axis, not patch {patch}, K = {K}")
    return variant


def v2_tile(patch: int) -> tuple[int, int, int]:
    """``"v2"``'s lanes a site ``G`` and a CTA's tile of ``TR x TC`` sites
    (256 lanes): 4 lanes on 8 x 8 sites at patch 1, 16 lanes on 4 x 4 above."""
    return (4, 8, 8) if patch == 1 else (16, 4, 4)


def v2_ctas(site_shape, patch: int) -> int:
    """The CTAs of a ``"v2"`` launch on ``(L, M, N)`` sites: the number the
    first of its L1-route counters is a share of."""
    L, M, N = site_shape
    _, TR, TC = v2_tile(patch)
    return L * -(-M // TR) * -(-N // TC)


def window_budget(K: int, dtype: torch.dtype) -> int:
    """``"v2"``'s default window budget in bytes: what its rule table (K^2
    points of 8 values) leaves of a CTA's 44 KB."""
    return _SMEM_BYTES - K * K * 8 * (4 if dtype == torch.float32 else 8)


def node_gq_torch(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                  patch: int = 1, origin=None, local_image_shape=None,
                  quad_chunk: int = 0) -> GQRaw:
    """Plain version of K4: ``gq_accumulate`` of the bicubic node potential
    over the K^2 rule, ``quad_chunk`` points a step."""
    f = make_node_pot_bicubic(I1, VV, lambdad, epsn, patch=patch, origin=origin,
                              local_image_shape=local_image_shape)
    return gq_accumulate(f, muu, muv, su, sv, pn,
                         table_on(K, quad_chunk, False, muu.dtype, muu.device))


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@functools.lru_cache(maxsize=None)
def _rule_host(K: int, dtype: torch.dtype) -> np.ndarray:
    """:func:`node_rule` on the host, copied into the launch's parameters;
    kept alive by the cache."""
    return np.ascontiguousarray(node_rule(K, _NP_DTYPES[dtype]))


def node_gq_cuda(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                 patch: int = 1, origin=None, local_image_shape=None,
                 variant: str | None = None, window_bytes: int | None = None,
                 l1_counts: torch.Tensor | None = None) -> GQRaw:
    """Kernel K4 over every point of the K^2 rule.

    ``variant``: one of :data:`VARIANTS` (None: :func:`resolve_variant`).
    For ``"v2"``, ``window_bytes`` is a CTA's shared-memory budget for its
    window of ``VV`` (None: :func:`window_budget`; 0 sends every site
    through L1), and ``l1_counts``, if given, an int64 tensor of 2 on the
    state's device that the kernel adds to: its CTAs with no window (of
    :func:`v2_ctas`) and its sites read through L1 (a site whose box of the
    table alone exceeds the budget, or with a non-finite input, or in a CTA
    with no window). Both routes give the same sums, bit for bit."""
    if muu.device.type != "cuda":
        raise RuntimeError(f"node_gq_cuda needs CUDA tensors, got {muu.device}")
    if muu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node_gq_cuda takes float32 or float64, not {muu.dtype}")
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    if I1.ndim != 2 or VV.ndim != 2 or min(VV.shape) < 4:
        raise ValueError(f"I1 must be 2-D and VV a padded 2-D table, got {tuple(I1.shape)} "
                         f"and {tuple(VV.shape)}")
    L, M, N = muu.shape
    for name, x, shape in (("I1", I1, I1.shape), ("VV", VV, VV.shape), ("muu", muu, muu.shape),
                           ("muv", muv, muu.shape), ("su", su, muu.shape),
                           ("sv", sv, muu.shape), ("pn", pn, muu.shape)):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.device != muu.device or x.dtype != muu.dtype:
            raise ValueError(f"{name} must share muu's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Mo, No = I1.shape
    Ml, Nl = (Mo, No) if local_image_shape is None else map(int, local_image_shape)
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    if (Ml, Nl) != (M * patch, N * patch) or r0 < 0 or c0 < 0 or r0 + Ml > Mo or c0 + Nl > No:
        raise ValueError(f"the ({M}, {N}) lattice of {patch} x {patch} blocks at pixel "
                         f"({r0}, {c0}) does not cover a {Ml} x {Nl} block of the {Mo} x {No} "
                         "frame")
    K = int(K)
    if not takes(K):
        raise ValueError(f"node_gq_cuda takes rules of 1 to {MAX_K} points an axis, not {K}")
    code = VARIANTS.index(resolve_variant(variant, K, patch))
    table = K * K * 8 * muu.element_size()
    window = window_budget(K, muu.dtype) if window_bytes is None else int(window_bytes)
    if code == 1 and not 0 <= window <= _MAX_SMEM_BYTES - table:
        raise ValueError(f"window_bytes must lie in [0, {_MAX_SMEM_BYTES - table}] at K = {K}, "
                         f"got {window}")
    if l1_counts is not None and (l1_counts.device != muu.device
                                  or l1_counts.dtype != torch.int64 or l1_counts.shape != (2,)):
        raise ValueError("l1_counts must be an int64 tensor of 2 on the state's device")
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    fn = lib.gqmap_node_gq_f32 if muu.dtype == torch.float32 else lib.gqmap_node_gq_f64
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    build.check(fn(I1.data_ptr(), VV.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                   sv.data_ptr(), pn.data_ptr(), _rule_host(K, muu.dtype).ctypes.data,
                   out.data_ptr(), None if l1_counts is None else l1_counts.data_ptr(), No,
                   VV.shape[0], VV.shape[1], L, M, N, int(patch), r0, c0, K, code, window,
                   float(lambdad), float(epsn), muu.device.index, stream),
                "node_gq_cuda")
    node_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


node_gq_cuda.launches = 0


def node_gq(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float, patch: int = 1,
            origin=None, local_image_shape=None, quad_chunk: int = 0) -> GQRaw:
    """Kernel K4 (its default variant) for CUDA tensors, its plain version
    (``quad_chunk`` points a step) for CPU tensors."""
    at = dict(patch=patch, origin=origin, local_image_shape=local_image_shape)
    if muu.device.type == "cpu":
        return node_gq_torch(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn,
                             quad_chunk=quad_chunk, **at)
    return node_gq_cuda(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn, **at)
