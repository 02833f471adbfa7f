"""Kernel K12: the windowed bicubic node term's K^2-point raw sums, on the card.

The data cost of ``legacy/gqmap_cpuV3.m:30-32`` (``data_term="bicubic"``,
``window_rg > 0``): the mean Charbonnier cost of frame 2's bicubic samples
over a ``(2 rg + 1)^2`` window that shares one displacement, summed by
``gq_accumulate`` over ``make_node_pot_windowed(base="bicubic")``, which the
JAX package runs as one XLA scan (``gqmap_tpu/ops/gq.py:93`` on
``gqmap_tpu/ops/potentials.py:142``) and no Pallas kernel. The CUDA kernels
are ``window_gq_kernel`` and ``window_gq_v2_kernel`` in
``gqmap_tpu_torch/csrc/node_gq.cu``, beside K4, whose device functions they
share (the source's notes say how); their plain PyTorch version is
:func:`node_window_gq_torch`, exactly what the sweep ran before the kernel.
Two variants (:data:`VARIANTS`), the same sums bit for bit: ``"v1"``, a
site's frame-1 window and its tap rows in registers, scalar loads, a
compiled instance for float32 at K = 9, rg = 2 only; ``"v2"`` (the
default), frame 1 in a shared tile and the window of ``VV`` as shifted
copies read by 16-byte loads, fewer registers, compiled at every radius.

* :func:`node_window_gq_cuda` launches the kernel (and raises for tensors
  that are not on a CUDA device); ``node_window_gq_cuda.launches`` counts
  its launches, of either variant.
* :func:`node_window_gq` launches the kernel for CUDA tensors and runs the
  plain version for CPU tensors.

All three take frame 1 ``I1`` (the whole ``(Mo, No)`` frame), ``VV =
pad_cubic(I2)`` (``(Mo + 2, No + 2)``), the ``(L, M, N)`` state ``muu, muv,
su, sv, pn`` on the pixel lattice, the window's radius ``rg`` and, on a
shard, the block's pixel ``origin`` (row, column) and ``local_image_shape``
(as ``make_node_pot_windowed``); they return the raw sums as :class:`GQRaw`
with ``(L, M, N)`` fields, ``finalize`` being the caller's. The kernel takes
rules up to :data:`MAX_K` points an axis and radii 1 to :data:`MAX_RG`
(:func:`takes`).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.gq import GQRaw, gq_accumulate
from ..ops.potentials import make_node_pot_windowed
from ..ops.quadrature import table_on
from . import build
from .node_gq import _MAX_SMEM_BYTES, _SMEM_BYTES, V2_MAX_K, _rule_host

__all__ = ["MAX_K", "MAX_RG", "TILE", "VARIANTS", "frame1_bytes", "node_window_gq",
           "node_window_gq_cuda", "node_window_gq_torch", "occupancy", "resolve_variant",
           "takes", "window_budget", "window_ctas"]

MAX_K = V2_MAX_K  # its per-point constant table, as K4 v2's
MAX_RG = 4  # the largest window radius (csrc/node_gq.cu kMaxRg)
# lanes a site G, and a CTA's TR x TC sites, in both variants (csrc/node_gq.cu WinTile)
TILE = (4, 8, 8)
VARIANTS = ("v1", "v2")  # kernel codes 0, 1
_DEFAULT_VARIANT = "v2"
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def takes(K: int, rg: int) -> bool:
    """Whether K12 computes the term for a K-point rule and radius ``rg``."""
    return 1 <= int(K) <= MAX_K and 1 <= int(rg) <= MAX_RG


def resolve_variant(variant: str | None, K: int, rg: int, dtype=torch.float32) -> str:
    """The variant a launch runs: ``variant``, or with None
    ``_DEFAULT_VARIANT``. Both are compiled for every rule and radius K12
    takes, in float32 and float64; anything else raises."""
    if dtype not in _ITEMSIZE:
        raise ValueError(f"K12 takes float32 or float64, not {dtype}")
    if not takes(K, rg):
        raise ValueError(f"K12 takes rules of 1 to {MAX_K} points an axis and window radii 1 to "
                         f"{MAX_RG}, not K = {K}, rg = {rg}")
    if variant is None:
        return _DEFAULT_VARIANT
    if variant not in VARIANTS:
        raise ValueError(f"unknown window_gq kernel variant {variant!r}")
    return variant


def window_ctas(site_shape) -> int:
    """The CTAs of a launch on ``(L, M, N)`` sites: the number the first of
    its L1-route counters is a share of."""
    L, M, N = site_shape
    _, TR, TC = TILE
    return L * -(-M // TR) * -(-N // TC)


def frame1_bytes(rg: int, dtype: torch.dtype, variant: str) -> int:
    """Shared memory of ``"v2"``'s frame-1 tile (``Frame1Tile`` in the
    source; 0 for ``"v1"``): the tile's ``TR + 2 rg`` rows as 16 / itemsize
    shifted copies, each row ``TC + P + V - 2`` elements rounded up to whole
    16-byte vectors, each copy padded to 16 bytes past a multiple of 128."""
    if variant == "v1":
        return 0
    size = _ITEMSIZE[dtype]
    V, P, (_, TR, TC) = 16 // size, 2 * rg + 1, TILE
    S = -(-(TC + P + V - 2) // V) * V
    n = (TR + 2 * rg) * S
    unit = 128 // size
    return V * (n + (V - n % unit) % unit) * size


def window_budget(K: int, rg: int, dtype: torch.dtype, variant: str) -> int:
    """The default window budget in bytes: what a variant's rule table (K^2
    points of 8 values) and frame-1 tile leave of a CTA's 44 KB."""
    return _SMEM_BYTES - K * K * 8 * _ITEMSIZE[dtype] - frame1_bytes(rg, dtype, variant)


def occupancy(K: int, rg: int, dtype: torch.dtype, variant: str | None = None,
              generic: bool = False, window_bytes: int | None = None,
              device: torch.device | None = None) -> dict:
    """The instance a launch would run, on the card: its registers a thread,
    its local memory (bytes a thread: stack frame and spills) and the CTAs
    an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) with the
    default or the given window budget."""
    variant = resolve_variant(variant, K, rg, dtype)
    window = window_budget(K, rg, dtype, variant) if window_bytes is None else int(window_bytes)
    index = torch.cuda.current_device() if device is None or device.index is None else (
        device.index)
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(build.library_for(torch.device("cuda", index)).gqmap_window_gq_occupancy(
        int(dtype == torch.float64), VARIANTS.index(variant), int(K), int(rg), int(generic),
        window, index, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas)),
        "window_gq.occupancy")
    return dict(registers=regs.value, local_bytes=local.value, ctas_per_sm=ctas.value)


def node_window_gq_torch(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                         rg: int, origin=None, local_image_shape=None,
                         quad_chunk: int = 0) -> GQRaw:
    """Plain version of K12: ``gq_accumulate`` of the windowed bicubic node
    potential over the K^2 rule, ``quad_chunk`` points a step."""
    f = make_node_pot_windowed(I1, VV, lambdad, epsn, rg, "bicubic", origin=origin,
                               local_image_shape=local_image_shape)
    return gq_accumulate(f, muu, muv, su, sv, pn,
                         table_on(K, quad_chunk, False, muu.dtype, muu.device))


def node_window_gq_cuda(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                        rg: int, origin=None, local_image_shape=None,
                        variant: str | None = None, window_bytes: int | None = None,
                        l1_counts: torch.Tensor | None = None, generic: bool = False) -> GQRaw:
    """Kernel K12 over every point of the K^2 rule.

    ``variant``: one of :data:`VARIANTS` (None: :func:`resolve_variant`).
    ``window_bytes``: a CTA's shared-memory budget for its window of ``VV``
    (None: :func:`window_budget`; 0 sends every site through L1);
    ``l1_counts``, if given, an int64 tensor of 2 on the state's device that
    the kernel adds to: its CTAs with no window (of :func:`window_ctas`) and
    its sites read through L1. Both routes and both variants give the same
    sums, bit for bit. ``generic`` runs the runtime-K instance (in ``"v1"``
    also runtime rg) where a compiled one exists (float32 at K = 9; in
    ``"v1"`` only at rg = 2)."""
    build.check_operands("node_window_gq_cuda", muu, ())
    if muu.ndim != 3 or I1.ndim != 2:
        raise ValueError(f"muu must be (L, M, N) and I1 2-D, got {tuple(muu.shape)} and "
                         f"{tuple(I1.shape)}")
    L, M, N = muu.shape
    Mo, No = I1.shape
    build.check_operands("node_window_gq_cuda", muu, (
        (name, x, shape) for name, x, shape in (
            ("I1", I1, (Mo, No)), ("VV", VV, (Mo + 2, No + 2)), ("muu", muu, (L, M, N)),
            ("muv", muv, (L, M, N)), ("su", su, (L, M, N)), ("sv", sv, (L, M, N)),
            ("pn", pn, (L, M, N)))))
    Ml, Nl = (Mo, No) if local_image_shape is None else map(int, local_image_shape)
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    if (Ml, Nl) != (M, N) or r0 < 0 or c0 < 0 or r0 + Ml > Mo or c0 + Nl > No:
        raise ValueError(f"the ({M}, {N}) lattice at pixel ({r0}, {c0}) does not cover a "
                         f"{Ml} x {Nl} block of the {Mo} x {No} frame")
    K, rg = int(K), int(rg)
    variant = resolve_variant(variant, K, rg, muu.dtype)
    most = (_MAX_SMEM_BYTES - K * K * 8 * muu.element_size()
            - frame1_bytes(rg, muu.dtype, variant))
    window = (window_budget(K, rg, muu.dtype, variant) if window_bytes is None
              else int(window_bytes))
    if not 0 <= window <= most:
        raise ValueError(f"window_bytes must lie in [0, {most}] at K = {K}, got {window}")
    if l1_counts is not None and (l1_counts.device != muu.device
                                  or l1_counts.dtype != torch.int64 or l1_counts.shape != (2,)):
        raise ValueError("l1_counts must be an int64 tensor of 2 on the state's device")
    out = torch.empty((6, L, M, N), dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    fn = lib.gqmap_window_gq_f32 if muu.dtype == torch.float32 else lib.gqmap_window_gq_f64
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    rule = _rule_host(K, muu.dtype)  # held through the call, which copies it
    build.check(fn(I1.data_ptr(), VV.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                   sv.data_ptr(), pn.data_ptr(), rule.ctypes.data, out.data_ptr(),
                   None if l1_counts is None else l1_counts.data_ptr(), Mo, No, Mo + 2, No + 2,
                   L, M, N, r0, c0, K, rg, window, int(bool(generic)), VARIANTS.index(variant),
                   float(lambdad), float(epsn), muu.device.index, stream),
                "node_window_gq_cuda")
    node_window_gq_cuda.launches += 1
    return GQRaw(*out.unbind(0))


node_window_gq_cuda.launches = 0


def node_window_gq(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float, rg: int,
                   origin=None, local_image_shape=None, quad_chunk: int = 0,
                   variant: str | None = None) -> GQRaw:
    """Kernel K12 (``variant``, None: the default) for CUDA tensors, its
    plain version (``quad_chunk`` points a step) for CPU tensors, whatever
    the variant."""
    at = dict(origin=origin, local_image_shape=local_image_shape)
    if muu.device.type == "cpu":
        return node_window_gq_torch(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn, rg,
                                    quad_chunk=quad_chunk, **at)
    return node_window_gq_cuda(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn, rg,
                               variant=variant, **at)
