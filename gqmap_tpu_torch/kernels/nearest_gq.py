"""Kernels K6 and K7: the legacy families' nearest-lookup node quadrature, on the card.

The node terms of ``data_term="nearest"`` (``legacy_v2``, ``blockmatch_v2``,
``full_mixture(data_term="nearest")``) and of the Prewitt estimator
(``legacy_v3``), which the JAX package runs as XLA scans and no Pallas
kernel:

* K6: ``gq_accumulate`` (``gqmap_tpu/ops/gq.py:93``) over
  ``make_node_pot_nearest`` (``gqmap_tpu/ops/potentials.py:100``) or, with a
  window half-size ``rg > 0``, ``make_node_pot_windowed(base="nearest")``
  (``:142``): the six raw sums of :class:`GQRaw`;
* K7: ``gq_accumulate_chain`` (``ops/gq.py:339``) over
  ``make_node_pot_nearest_chain`` (``potentials.py:211``): the seven raw
  sums of :class:`GQChainRaw`.

The CUDA kernels are ``gqmap_tpu_torch/csrc/nearest_gq.cu`` (its notes say
how they are laid out); their plain PyTorch versions are
:func:`nearest_gq_torch` and :func:`nearest_chain_gq_torch`, exactly what
the sweep ran before the kernels. ``finalize`` and ``finalize_chain`` are
the caller's. Each kernel has two variants (:data:`VARIANTS`): ``"v1"``
reads the table (one thread a site), ``"v2"`` evaluates each looked-up cell
from the padded field ``pad_cubic(I2)`` (and, K7, the Prewitt fields' pads)
by the table's own phase stencil (``ops/interp.phase_weights``), bit for bit
the table's value, with a site's 8 lanes over its points;
:func:`resolve_variant` picks ``"v2"`` where it takes the shape.

* :func:`nearest_gq_cuda` and :func:`nearest_chain_gq_cuda` launch the
  kernels (and raise for tensors that are not on a CUDA device); their
  ``launches`` count the launches.
* :func:`nearest_gq` and :func:`nearest_chain_gq` launch the kernel for
  CUDA tensors and run the plain version for CPU tensors.

Each takes frame 1 ``I1`` (the whole ``(Mo, No)`` frame), the upsampled
table ``tab = upsample_cubic(I2, rfc)`` (K7 also its two upsampled Prewitt
fields), the ``(L, M, N)`` state ``muu, muv, su, sv, pn`` of one pixel a
site, the rule's order ``K``, ``lambdad``, ``epsn``, ``rfc`` and, on a shard,
the block's pixel ``origin`` (row, column) and ``local_image_shape``, as the
potentials take them, and ``pads``, the padded fields ``Problem.nearest_pads``
that ``"v2"`` reads (the plain versions read the table and take ``pads`` only
to share the signature). The plain versions and the dispatchers also take
``quad_chunk``, the plain version's points a step (0: all); the kernels take
every point of the rule in one pass. :func:`lookup_sectors` counts the
distinct 32-byte sectors of the table that a state's lookups touch, the
table bytes of ``kernels/roofline.k6_work`` and ``k7_work``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.gq import GQChainRaw, GQRaw, _whitened_steps, gq_accumulate, gq_accumulate_chain
from ..ops.interp import phase_weights
from ..ops.potentials import (_nearest_index, make_node_pot_nearest, make_node_pot_nearest_chain,
                              make_node_pot_windowed)
from ..ops.quadrature import table_on
from . import build
from .node_gq import node_rule
from .roofline import SECTOR_BYTES

__all__ = ["MAX_K", "V2_MAX_K", "V2_MAX_RFC", "VARIANTS", "lookup_sectors", "nearest_chain_gq",
           "nearest_chain_gq_cuda", "nearest_chain_gq_torch", "nearest_gq", "nearest_gq_cuda",
           "nearest_gq_torch", "resolve_variant", "takes"]

MAX_K = 64  # the largest rule the kernels take (csrc/nearest_gq.cu, kMaxK)
MAX_RFC = 20  # the largest upsampling exponent they take
V2_MAX_K, V2_MAX_RFC = 24, 8  # "v2"'s (kV2MaxK, kV2MaxRfc: its tables in 48 KB)
VARIANTS = ("v1", "v2")
_DEFAULT_VARIANT = "v2"


def takes(K: int, rfc: int) -> bool:
    """Whether K6 and K7 compute the term for a K-point rule on the
    ``2^rfc``-times upsampled table: at most :data:`MAX_K` points an axis
    and ``rfc`` at most :data:`MAX_RFC` (``"v1"``; ``"v2"`` where
    :func:`resolve_variant` picks it)."""
    return 1 <= int(K) <= MAX_K and 0 <= int(rfc) <= MAX_RFC


def resolve_variant(variant: str | None, K: int, rfc: int) -> str:
    """The variant a launch runs: ``variant``, or with None ``"v2"`` where
    it takes the shape (``K`` at most :data:`V2_MAX_K`, ``rfc`` at most
    :data:`V2_MAX_RFC`) and ``"v1"`` elsewhere; an explicit ``"v2"`` outside
    that raises."""
    fits = int(K) <= V2_MAX_K and int(rfc) <= V2_MAX_RFC
    if variant is None:
        return _DEFAULT_VARIANT if fits else "v1"
    if variant not in VARIANTS:
        raise ValueError(f"unknown nearest_gq kernel variant {variant!r}")
    if variant == "v2" and not fits:
        raise ValueError(f"nearest_gq variant 'v2' takes rules of at most {V2_MAX_K} points an "
                         f"axis and rfc at most {V2_MAX_RFC}, not K = {K}, rfc = {rfc}")
    return variant


def nearest_gq_torch(I1, tab, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                     rfc: int, rg: int = 0, origin=None, local_image_shape=None,
                     quad_chunk: int = 0, pads=None) -> GQRaw:
    """Plain version of K6: ``gq_accumulate`` of the nearest-lookup potential
    (the mean over the ``(2 rg + 1)^2`` window for ``rg > 0``) over the K^2
    rule, ``quad_chunk`` points a step."""
    at = dict(origin=origin, local_image_shape=local_image_shape)
    if rg > 0:
        f = make_node_pot_windowed(I1, tab, lambdad, epsn, rg, "nearest", rfc, **at)
    else:
        f = make_node_pot_nearest(I1, tab, lambdad, epsn, rfc, **at)
    return gq_accumulate(f, muu, muv, su, sv, pn,
                         table_on(K, quad_chunk, False, muu.dtype, muu.device))


def nearest_chain_gq_torch(I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, K: int,
                           lambdad: float, epsn: float, rfc: int, origin=None,
                           local_image_shape=None, quad_chunk: int = 0,
                           pads=None) -> GQChainRaw:
    """Plain version of K7: ``gq_accumulate_chain`` of the Prewitt chain
    potential over the K^2 rule, ``quad_chunk`` points a step."""
    fg = make_node_pot_nearest_chain(I1, tab, tab_u, tab_v, lambdad, epsn, rfc, origin=origin,
                                     local_image_shape=local_image_shape)
    return gq_accumulate_chain(fg, muu, muv, su, sv, pn,
                               table_on(K, quad_chunk, False, muu.dtype, muu.device))


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@functools.lru_cache(maxsize=None)
def _rule_host(K: int, dtype: torch.dtype) -> np.ndarray:
    """:func:`.node_gq.node_rule` in the launch's type on the host, copied
    into the launch's parameters; kept alive by the cache."""
    return np.ascontiguousarray(node_rule(K, _NP_DTYPES[dtype]))


@functools.lru_cache(maxsize=None)
def _weights_on(rfc: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`..ops.interp.phase_weights` on the launch's device, made once
    (a captured sweep copies nothing from the host): the tensor expression
    ``upsample_cubic`` weighs its taps with on that device."""
    return phase_weights(rfc, dtype, device)


def _check_pads(what, I1, pads, n, rfc, state):
    """``"v2"``'s padded fields: the first ``n`` of ``pads``, each ``(Mo + 2,
    No + 2)``, contiguous, on the state's device and in its type."""
    muu = state[0]
    if pads is None or len(pads) < n:
        raise ValueError(f"{what} variant 'v2' reads the padded field{'s' if n > 1 else ''} "
                         f"(Problem.nearest_pads, pad_cubic of frame 2"
                         f"{' and of its Prewitt fields' if n > 1 else ''}): pass pads=")
    want = (I1.shape[0] + 2, I1.shape[1] + 2)
    for k, x in enumerate(pads[:n]):
        if tuple(x.shape) != want:
            raise ValueError(f"pad {k} has shape {tuple(x.shape)}, expected {want}")
        if x.device != muu.device or x.dtype != muu.dtype:
            raise ValueError(f"pad {k} must share muu's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"pad {k} must be contiguous")
    return pads[:n], _weights_on(int(rfc), muu.dtype, muu.device)


def _check(what, I1, tabs, state, K, rfc, rg, origin, local_image_shape):
    """The launch's shared checks; returns ``(r0, c0)``."""
    muu = state[0]
    if muu.device.type != "cuda":
        raise RuntimeError(f"{what} needs CUDA tensors, got {muu.device}")
    if muu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, not {muu.dtype}")
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    if I1.ndim != 2 or tabs[0].ndim != 2:
        raise ValueError(f"I1 and the table must be 2-D, got {tuple(I1.shape)} and "
                         f"{tuple(tabs[0].shape)}")
    named = [("I1", I1, I1.shape)] + [(f"table {k}", x, tabs[0].shape) for k, x in
                                      enumerate(tabs)]
    named += [(name, x, muu.shape) for name, x in zip(("muu", "muv", "su", "sv", "pn"), state)]
    for name, x, shape in named:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.device != muu.device or x.dtype != muu.dtype:
            raise ValueError(f"{name} must share muu's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _, M, N = muu.shape
    Mo, No = I1.shape
    Ml, Nl = (Mo, No) if local_image_shape is None else map(int, local_image_shape)
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    if (Ml, Nl) != (M, N) or r0 < 0 or c0 < 0 or r0 + Ml > Mo or c0 + Nl > No:
        raise ValueError(f"the ({M}, {N}) lattice of pixels at ({r0}, {c0}) does not cover a "
                         f"{Ml} x {Nl} block of the {Mo} x {No} frame")
    if not takes(K, rfc) or int(rg) < 0:
        raise ValueError(f"{what} takes rules of 1 to {MAX_K} points an axis, rfc in "
                         f"[0, {MAX_RFC}] and rg >= 0, not K = {K}, rfc = {rfc}, rg = {rg}")
    return r0, c0


def nearest_gq_cuda(I1, tab, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                    rfc: int, rg: int = 0, origin=None, local_image_shape=None, pads=None,
                    variant: str | None = None) -> GQRaw:
    """Kernel K6 over every point of the K^2 rule and every tap of the
    ``(2 rg + 1)^2`` window; ``variant`` by :func:`resolve_variant`,
    ``"v2"`` reading ``pads[0]`` (``pad_cubic`` of frame 2) where ``"v1"``
    reads ``tab``."""
    state = (muu, muv, su, sv, pn)
    r0, c0 = _check("nearest_gq_cuda", I1, (tab,), state, K, rfc, rg, origin,
                    local_image_shape)
    variant = resolve_variant(variant, K, rfc)
    if variant == "v2":
        (pad,), wts = _check_pads("nearest_gq_cuda", I1, pads, 1, rfc, state)
    L, M, N = muu.shape
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    f32 = muu.dtype == torch.float32
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    rule = _rule_host(int(K), muu.dtype).ctypes.data
    sites = [x.data_ptr() for x in state]
    if variant == "v2":
        fn = lib.gqmap_nearest_gq_v2_f32 if f32 else lib.gqmap_nearest_gq_v2_f64
        code = fn(I1.data_ptr(), pad.data_ptr(), wts.data_ptr(), *sites, rule, out.data_ptr(),
                  *I1.shape, *pad.shape, L, M, N, r0, c0, int(K), int(rg), int(rfc),
                  float(lambdad), float(epsn), muu.device.index, stream)
    else:
        fn = lib.gqmap_nearest_gq_f32 if f32 else lib.gqmap_nearest_gq_f64
        code = fn(I1.data_ptr(), tab.data_ptr(), *sites, rule, out.data_ptr(), *I1.shape,
                  *tab.shape, L, M, N, r0, c0, int(K), int(rg), int(rfc), float(lambdad),
                  float(epsn), muu.device.index, stream)
    build.check(code, f"nearest_gq_cuda ({variant})")
    nearest_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


nearest_gq_cuda.launches = 0


def nearest_chain_gq_cuda(I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, K: int, lambdad: float,
                          epsn: float, rfc: int, origin=None, local_image_shape=None, pads=None,
                          variant: str | None = None) -> GQChainRaw:
    """Kernel K7 over every point of the K^2 rule; ``variant`` by
    :func:`resolve_variant`, ``"v2"`` reading the three ``pads`` where
    ``"v1"`` reads the three tables."""
    state = (muu, muv, su, sv, pn)
    r0, c0 = _check("nearest_chain_gq_cuda", I1, (tab, tab_u, tab_v), state, K, rfc, 0, origin,
                    local_image_shape)
    variant = resolve_variant(variant, K, rfc)
    if variant == "v2":
        fields, wts = _check_pads("nearest_chain_gq_cuda", I1, pads, 3, rfc, state)
    L, M, N = muu.shape
    out = torch.empty((7, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    f32 = muu.dtype == torch.float32
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    rule = _rule_host(int(K), muu.dtype).ctypes.data
    sites = [x.data_ptr() for x in state]
    if variant == "v2":
        fn = lib.gqmap_nearest_chain_v2_f32 if f32 else lib.gqmap_nearest_chain_v2_f64
        code = fn(I1.data_ptr(), *(x.data_ptr() for x in fields), wts.data_ptr(), *sites, rule,
                  out.data_ptr(), *I1.shape, *fields[0].shape, L, M, N, r0, c0, int(K),
                  int(rfc), float(lambdad), float(epsn), muu.device.index, stream)
    else:
        fn = lib.gqmap_nearest_chain_f32 if f32 else lib.gqmap_nearest_chain_f64
        code = fn(I1.data_ptr(), tab.data_ptr(), tab_u.data_ptr(), tab_v.data_ptr(), *sites,
                  rule, out.data_ptr(), *I1.shape, *tab.shape, L, M, N, r0, c0, int(K),
                  int(rfc), float(lambdad), float(epsn), muu.device.index, stream)
    build.check(code, f"nearest_chain_gq_cuda ({variant})")
    nearest_chain_gq_cuda.launches += 1
    return GQChainRaw(*out.unbind(0))


nearest_chain_gq_cuda.launches = 0


def nearest_gq(I1, tab, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float, rfc: int,
               rg: int = 0, origin=None, local_image_shape=None, quad_chunk: int = 0,
               pads=None) -> GQRaw:
    """Kernel K6 (its default variant) for CUDA tensors, its plain version
    (``quad_chunk`` points a step) for CPU tensors."""
    args = (I1, tab, muu, muv, su, sv, pn, K, lambdad, epsn, rfc, rg, origin, local_image_shape)
    if muu.device.type == "cpu":
        return nearest_gq_torch(*args, quad_chunk=quad_chunk)
    return nearest_gq_cuda(*args, pads=pads)


def nearest_chain_gq(I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, K: int, lambdad: float,
                     epsn: float, rfc: int, origin=None, local_image_shape=None,
                     quad_chunk: int = 0, pads=None) -> GQChainRaw:
    """Kernel K7 (its default variant) for CUDA tensors, its plain version
    (``quad_chunk`` points a step) for CPU tensors."""
    args = (I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, K, lambdad, epsn, rfc, origin,
            local_image_shape)
    if muu.device.type == "cpu":
        return nearest_chain_gq_torch(*args, quad_chunk=quad_chunk)
    return nearest_chain_gq_cuda(*args, pads=pads)


def lookup_sectors(tab, muu, muv, su, sv, pn, K: int, rfc: int, rg: int = 0,
                   origin=None) -> tuple[int, int]:
    """``(lookups, sectors)``: the table lookups of K6 (K7 at ``rg = 0``) on
    this state, and the distinct 32-byte sectors of ``tab`` they touch, from
    the plain version's own indices (``ops/potentials._nearest_index``, a
    negative index wrapped as torch wraps it), a site ``(l, m, n)`` at pixel
    ``origin + (m, n)``. Runs where the tensors are, K points a step."""
    _, M, N = muu.shape
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    jj = (1.0 + c0) + torch.arange(N, dtype=muu.dtype, device=muu.device).reshape(1, N)
    ii = (1.0 + r0) + torch.arange(M, dtype=muu.dtype, device=muu.device).reshape(M, 1)
    index = _nearest_index(tab.shape, rfc)
    per = SECTOR_BYTES // tab.element_size()
    hit = torch.zeros(-(-tab.numel() // per), dtype=torch.bool, device=tab.device)
    lookups = 0
    steps = _whitened_steps(muu, muv, su, sv, pn, table_on(K, K, False, muu.dtype, muu.device))
    for _, _, _, x1, x2 in steps:
        for di in range(-rg, rg + 1):
            for dj in range(-rg, rg + 1):
                idx = index(jj + dj + x1, ii + di + x2) % tab.numel()
                hit[idx // per] = True
                lookups += idx.numel()
    return lookups, int(hit.sum())
