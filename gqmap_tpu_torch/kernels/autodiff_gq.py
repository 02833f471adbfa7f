"""Kernels K13, K14 and K15: the autodiff estimator's sums, on the card.

Under ``gradient_estimator="autodiff"`` the JAX package takes
``jax.value_and_grad`` of the quadrature-estimated expected energy
(``gqmap_tpu/models/gqmap.py``): XLA scans of ``gq_ei`` and ``gq_ei_diff``
(``gqmap_tpu/ops/gq.py``) and their derivatives, no Pallas kernel. Here
each term's value and the sums of its exact derivatives come from one
launch, and a ``torch.autograd.Function`` scales them by the incoming
gradient (:func:`chain_ei`, :func:`diff_ei`); the rest of the estimator
stays ``torch.autograd`` of plain torch. The CUDA kernels are
``gqmap_tpu_torch/csrc/autodiff_gq.cu``:

* K13, :func:`node_chain_gq_cuda`: the bicubic node term without a window,
  one pixel a site or a super site's 4 x 4 block (``patch``), the seven
  chain-rule sums (:class:`GQChainRaw`) of its potential with its exact
  derivatives; plain version :func:`node_chain_gq_torch`
  (``gq_accumulate_chain`` on ``make_node_pot_bicubic_chain``);
* K16, :func:`node_window_chain_gq_cuda`: the windowed bicubic node term
  (``window_rg`` 1 to :data:`MAX_RG`), the same seven sums; plain version
  :func:`node_window_chain_gq_torch` (``gq_accumulate_chain`` on
  ``make_node_pot_windowed_chain``);
* K14, :func:`edge_chain_gq_cuda`: the tensor-rule Charbonnier edges, the
  same seven sums on the edge lattice; plain version
  :func:`edge_chain_gq_torch` (``gq_accumulate_chain`` on
  ``make_edge_pot_chain``);
* K15, :func:`edge_diff_adjoint_cuda`: the reduced Charbonnier edges, the
  value of ``gq_ei_diff`` and its five derivatives, the neighbour read in
  the kernel as K2 reads it; plain version :func:`edge_diff_adjoint_torch`
  (``gq_ei_diff_adjoint`` and ``diff_partials``).

K13, K14 and K15 have two variants (:data:`VARIANTS`, the same sums bit for
bit): ``"v1"``, the first versions (every tap through L1, the rules staged
into shared memory), and ``"v2"`` (the default where it is compiled,
:func:`resolve_variant`): K13 on K4 v2's machinery in
``csrc/node_gq.cu`` (a per-point constant table, a CTA's window of frame 2
in shared memory, the shared form of a query strictly inside the frame),
K14 with K3's rule by value, K15 with K2's (its two edges' pairs
interleaved); each with ``sqrtf``'s and the division's own fast paths
(``csrc/fast_div.cuh``), falling back to v1's arithmetic where those could
differ (the sources' notes say how). K13 at patch 4 and K16 are one
kernel of ``csrc/node_gq.cu`` (``chain_block_kernel``: a block of queries
that share a displacement, K4 v2's and K12 v2's tiles, frame 1 in a shared
tile, one weight set and one tap window a point, a per-tap fallback on the
border), K13's ``"v2"`` at patch 4 and K16's one variant, ``"v1"``.
:func:`takes` says which shapes a kernel takes at all.

Each ``*_cuda`` wrapper counts its launches (``.launches``, of either
variant) and raises for tensors that are not on a CUDA device; the
dispatchers (:func:`node_chain_gq`, :func:`node_window_chain_gq`,
:func:`edge_chain_gq`, :func:`edge_diff_adjoint`) launch the kernel for CUDA
tensors and run the plain version for CPU tensors. The plain versions also
take ``quad_chunk``, their points a step (0: all).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.gq import (GQChainRaw, chain_partials, diff_partials, gq_accumulate_chain,
                      gq_ei_diff_adjoint)
from ..ops.potentials import (make_edge_pot_chain, make_edge_pot_diff_grad,
                              make_node_pot_bicubic_chain, make_node_pot_windowed_chain)
from ..ops.quadrature import gauss_hermite, table_on
from . import build
from .edge_reduced_gq import neighbour_stacks, pad_halo, paired_rule_1d
from .node_gq import (_MAX_SMEM_BYTES, _SMEM_BYTES, V2_MAX_K, _rule_host, node_rule,
                      window_budget)

__all__ = ["CHAIN_PATCHES", "EDGE_DIFF_V2_K", "EDGE_V2_K", "MAX_K", "MAX_RG", "Partials",
           "VARIANTS", "chain_budget", "chain_ctas", "chain_ei", "chain_frame1_bytes",
           "chain_rule_struct", "chain_tile", "diff_ei", "edge_chain_gq", "edge_chain_gq_cuda",
           "edge_chain_gq_torch", "edge_diff_adjoint", "edge_diff_adjoint_cuda",
           "edge_diff_adjoint_torch", "node_chain_gq", "node_chain_gq_cuda", "node_chain_gq_torch",
           "node_window_chain_gq", "node_window_chain_gq_cuda", "node_window_chain_gq_torch",
           "occupancy", "paired_chain_rule", "point_constants", "resolve_variant", "takes"]

MAX_K = 64  # K13's largest rule at patch 1 (csrc/autodiff_gq.cu, kMaxK)
MAX_RG = 4  # K16's largest window radius (csrc/node_gq.cu kMaxRg)
CHAIN_PATCHES = (1, 4)  # the patches K13 is compiled for (4: v2 alone)
VARIANTS = ("v1", "v2")
_DEFAULT_VARIANT = "v2"  # K13, K14 and K15 (patch it to capture a graph through v1)
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}
EDGE_V2_K = (9,)  # K14 v2's rules by value (csrc/autodiff_gq.cu ChainRule); others generic
# K15 v2's rules by value (K2's EdgeRule1D, csrc/edge_rule_1d.cuh): tpu_fast's K1 = 21 and
# the super presets' 25; others generic
EDGE_DIFF_V2_K = (21, 25)


def takes(kernel: str, K: int, dtype=torch.float32, patch: int = 1, rg: int = 0) -> bool:
    """Whether ``kernel`` ("K13", "K14", "K15" or "K16"; K15's K is its K1)
    computes its term for that shape (the limits of all its variants
    together): K13 1 to :data:`MAX_K` points an axis at ``patch`` 1, and 1
    to :data:`~.node_gq.V2_MAX_K` at patch 4 (v2 alone, its point table);
    K16 1 to :data:`~.node_gq.V2_MAX_K` points an axis and window radii
    ``rg`` 1 to :data:`MAX_RG`; K14 and K15 any rule whose paired values
    (``5 P + 1`` of :func:`paired_chain_rule`, ``4 P + 1`` of
    ``paired_rule_1d``) fit v1's shared memory (``build.rule_fits``)."""
    K = int(K)
    if kernel == "K13":
        return int(patch) in CHAIN_PATCHES and 1 <= K <= (MAX_K if int(patch) == 1 else V2_MAX_K)
    if kernel == "K16":
        return 1 <= K <= V2_MAX_K and 1 <= int(rg) <= MAX_RG
    if kernel == "K14":
        return K >= 1 and build.rule_fits(5 * (K * K // 2) + 1, dtype)
    if kernel == "K15":
        return K >= 1 and build.rule_fits(4 * (K // 2) + 1, dtype)
    raise ValueError(f"unknown autodiff kernel {kernel!r}: K13, K14, K15 or K16")


def resolve_variant(kernel: str, variant: str | None, K: int, dtype=torch.float32,
                    patch: int = 1, rg: int = 0) -> str:
    """The variant of ``kernel`` ("K13", "K14", "K15" or "K16"; K15's K is
    its K1) a launch runs: ``variant``, or with None ``"v2"`` where it is
    compiled and ``"v1"`` elsewhere; an explicit variant outside that
    raises. K13 v2 takes rules up to :data:`~.node_gq.V2_MAX_K` points an
    axis (its per-point table) and is K13's only variant at patch 4; K14 v2
    and K15 v2 take at least 2 (``rule_instance.cuh``), each within v1's
    limits (:func:`takes`). K16 has one variant, ``"v1"``."""
    if kernel not in ("K13", "K14", "K15", "K16"):
        raise ValueError(f"no variants of {kernel!r}: K13, K14, K15 and K16 have them")
    K = int(K)
    ok = takes(kernel, K, dtype, patch=patch, rg=rg)
    if kernel == "K16":
        v1, v2 = ok, False
    elif kernel == "K13" and int(patch) != 1:
        v1, v2 = False, ok
    else:
        v1 = ok
        v2 = v1 and (K <= V2_MAX_K if kernel == "K13" else K >= 2)
    if variant is None:
        return _DEFAULT_VARIANT if v2 else "v1"
    if variant not in VARIANTS:
        raise ValueError(f"unknown {kernel} kernel variant {variant!r}")
    if not (v2 if variant == "v2" else v1):
        shape = f"K = {K}" + (f", patch {patch}" if kernel == "K13" else "") + (
            f", rg = {rg}" if kernel == "K16" else "")
        raise ValueError(f"{kernel} variant {variant!r} does not take {shape}")
    return variant


def chain_tile(rg: int) -> tuple[int, int, int]:
    """The chain-block kernel's lanes a site and its CTA's ``TR x TC`` sites
    (``ChainBlock`` in ``csrc/node_gq.cu``): K16 (``rg`` >= 1) K12's 4 lanes
    on 8 x 8 sites, K13 at patch 4 (``rg`` 0) K4 v2's 16 lanes on 4 x 4."""
    return (4, 8, 8) if rg > 0 else (16, 4, 4)


def chain_ctas(site_shape, rg: int) -> int:
    """The CTAs of a chain-block launch on ``(L, M, N)`` sites: the number
    the first of its L1-route counters is a share of."""
    L, M, N = site_shape
    _, TR, TC = chain_tile(rg)
    return L * -(-M // TR) * -(-N // TC)


def chain_frame1_bytes(rg: int, dtype: torch.dtype) -> int:
    """Shared memory of the chain-block kernel's frame-1 tile
    (``ChainFrame1``): ``(TR - 1) STEP + P`` rows (K16: P = 2 rg + 1, STEP
    1; K13 at patch 4: P = STEP = 4), each wide enough for its last block's
    16-byte reads; 16 / itemsize shifted copies, each padded to 16 bytes
    past a multiple of 128, where STEP is not a multiple of 16 / itemsize
    (K16), else one copy."""
    size = _ITEMSIZE[dtype]
    V = 16 // size
    _, TR, TC = chain_tile(rg)
    P, step = (2 * rg + 1, 1) if rg > 0 else (4, 4)
    R = (TR - 1) * step + P
    S = ((TC - 1) * step + P + 2 * V - 2) // V * V
    if step % V == 0:
        return R * S * size
    unit, n = 128 // size, R * S
    return V * (n + (V - n % unit) % unit) * size


def chain_budget(K: int, rg: int, dtype: torch.dtype) -> int:
    """The chain-block kernel's default window budget in bytes: what its
    point table (K^2 points of 8 values) and frame-1 tile leave of a CTA's
    44 KB (``rg`` 0: K13 at patch 4)."""
    return _SMEM_BYTES - K * K * 8 * _ITEMSIZE[dtype] - chain_frame1_bytes(rg, dtype)


def occupancy(K: int, rg: int, dtype: torch.dtype, generic: bool = False,
              window_bytes: int | None = None, device: torch.device | None = None) -> dict:
    """The chain-block instance a launch would run (K16 at radius ``rg``,
    K13 at patch 4 for ``rg`` 0), on the card: its registers a thread, its
    local memory (bytes a thread: stack frame and spills) and the CTAs an SM
    holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) with the
    default or the given window budget."""
    window = chain_budget(K, rg, dtype) if window_bytes is None else int(window_bytes)
    index = torch.cuda.current_device() if device is None or device.index is None else (
        device.index)
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(build.library_for(torch.device("cuda", index)).gqmap_chain_occupancy(
        int(dtype == torch.float64), int(K), int(rg), int(generic), window, index,
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas)), "autodiff_gq.occupancy")
    return dict(registers=regs.value, local_bytes=local.value, ctas_per_sm=ctas.value)


def point_constants(K: int, dtype=np.float64) -> np.ndarray:
    """K13 v2's per-point constants as ``point_table`` (``csrc/node_gq.cu``)
    builds them from :func:`node_rule` in ``dtype``, point ``p = j K + i``
    (XJ outer): ``(K^2, 3)`` of x_i, x_j and w_i w_j, the product rounded
    once, as v1 forms it."""
    x, w = np.split(node_rule(K, dtype), 2)
    k = np.arange(K * K)
    return np.stack([x[k % K], x[k // K], w[k % K] * w[k // K]], 1)


def paired_chain_rule(K: int, dtype=np.float64) -> np.ndarray:
    """K14's rule: ``5 P + 1`` values for the ``P = K^2 // 2`` pairs of a
    point (flat index ``j K + i``, XI = x_i, XJ = x_j) and its mirror ``K^2 -
    1`` minus it, row by row: XI, XJ, WIWJ, WIWJ XI and WIWJ XJ of the
    pair's first point; last the centre point's weight (odd K; 0 for even
    K). Nodes and weights symmetrised, as ``edge_gq.paired_rule``."""
    x, w = gauss_hermite(K)
    x = 0.5 * (x - x[::-1])
    w = 0.5 * (w + w[::-1])
    k = np.arange(K * K // 2)
    xi, xj = x[k % K], x[k // K]
    wiwj = w[k % K] * w[k // K]
    wc = w[K // 2] ** 2 if K % 2 else 0.0
    return np.concatenate([xi, xj, wiwj, wiwj * xi, wiwj * xj, [wc]]).astype(dtype)


def chain_rule_struct(K: int, dtype=np.float32) -> np.ndarray:
    """K14 v2's rule by value (``ChainRule<T, K>`` in ``csrc/autodiff_gq.cu``)
    as a numpy record: the P pairs' ``xi``, ``xj``, ``w``, ``wxi``, ``wxj``,
    then ``wc``, with no padding, so its bytes are :func:`paired_chain_rule`'s
    (804 for float32 at K = 9), which the launch copies into it."""
    P = K * K // 2
    rec = np.dtype([(f, dtype, (P,)) for f in ("xi", "xj", "w", "wxi", "wxj")] + [("wc", dtype)])
    return np.frombuffer(paired_chain_rule(K, dtype).tobytes(), dtype=rec)[0]


# --- K13 ---------------------------------------------------------------------------

def node_chain_gq_torch(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                        patch: int = 1, origin=None, local_image_shape=None,
                        quad_chunk: int = 0) -> GQChainRaw:
    """Plain version of K13: ``gq_accumulate_chain`` on the bicubic node
    potential with its exact derivatives (a super site's ``patch x patch``
    pixels summed), ``quad_chunk`` points a step."""
    fg = make_node_pot_bicubic_chain(I1, VV, lambdad, epsn, patch=patch, origin=origin,
                                     local_image_shape=local_image_shape)
    return gq_accumulate_chain(fg, muu, muv, su, sv, pn,
                               table_on(K, quad_chunk, False, muu.dtype, muu.device))


def _l1_counts_ok(l1_counts, like) -> None:
    if l1_counts is not None and (l1_counts.device != like.device or
                                  l1_counts.dtype != torch.int64 or l1_counts.shape != (2,)):
        raise ValueError("l1_counts must be an int64 tensor of 2 on the state's device")


def _block_at(name: str, I1, site, patch: int, origin, local_image_shape):
    """The pixel origin of a lattice of ``patch x patch`` blocks, checked
    against frame 1 (``local_image_shape`` the lattice's pixels)."""
    _, M, N = site
    Mo, No = I1.shape
    Ml, Nl = (M * patch, N * patch) if local_image_shape is None else map(int,
                                                                           local_image_shape)
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    if (Ml, Nl) != (M * patch, N * patch) or r0 < 0 or c0 < 0 or r0 + Ml > Mo or c0 + Nl > No:
        raise ValueError(f"{name}: the ({M}, {N}) lattice of {patch} x {patch} pixel blocks at "
                         f"pixel ({r0}, {c0}) does not cover a {Ml} x {Nl} block of the "
                         f"{Mo} x {No} frame")
    return r0, c0


def node_chain_gq_cuda(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                       patch: int = 1, origin=None, local_image_shape=None,
                       variant: str | None = None, window_bytes: int | None = None,
                       l1_counts: torch.Tensor | None = None,
                       generic: bool = False) -> GQChainRaw:
    """Kernel K13 on the ``(L, M, N)`` sites of frame 1's block at pixel
    ``origin`` (the whole frame by default; ``local_image_shape`` must be
    the sites' pixels, ``(M patch, N patch)``), one pixel a site or a super
    site's ``patch x patch`` block (``patch`` in :data:`CHAIN_PATCHES`).

    ``variant``: one of :data:`VARIANTS` (None: :func:`resolve_variant`;
    ``"v2"`` alone at patch 4). For ``"v2"``, ``window_bytes`` is a CTA's
    shared-memory budget for its window of ``VV`` (None: K4 v2's
    ``window_budget`` at patch 1, :func:`chain_budget` at patch 4; 0 sends
    every site through L1), ``l1_counts``, if given, an int64 tensor of 2 on
    the state's device that the kernel adds to (its CTAs with no window, of
    ``node_gq.v2_ctas(site_shape, 1)`` or :func:`chain_ctas`, and its sites
    read through L1), and ``generic`` runs the runtime-K instance where a
    compiled one exists (float32 K = 9 at patch 1, K = 11 at patch 4). Every
    route, instance and variant gives the same sums, bit for bit."""
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    L, M, N = muu.shape
    Mo, No = I1.shape
    site = muu.shape
    build.check_operands("node_chain_gq_cuda", muu, (
        ("I1", I1, (Mo, No)), ("VV", VV, (Mo + 2, No + 2)), ("muu", muu, site),
        ("muv", muv, site), ("su", su, site), ("sv", sv, site), ("pn", pn, site)))
    patch, K = int(patch), int(K)
    if not takes("K13", K, muu.dtype, patch=patch):
        raise ValueError(f"K13 takes patch in {CHAIN_PATCHES} and rules of 1 to {MAX_K} points "
                         f"an axis at patch 1, 1 to {V2_MAX_K} at patch 4, not patch {patch}, "
                         f"K = {K}")
    r0, c0 = _block_at("node_chain_gq_cuda", I1, site, patch, origin, local_image_shape)
    variant = resolve_variant("K13", variant, K, muu.dtype, patch=patch)
    out = torch.empty((7,) + site, dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    f32 = muu.dtype == torch.float32
    stream = torch.cuda.current_stream(muu.device).cuda_stream
    if variant == "v1":
        rule, _, rule_dev = build.rule_args(node_rule, K, (), True, muu)
        fn = lib.gqmap_node_chain_f32 if f32 else lib.gqmap_node_chain_f64
        code = fn(I1.data_ptr(), VV.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                  sv.data_ptr(), pn.data_ptr(), rule_dev, out.data_ptr(), Mo, No, L, M, N, r0,
                  c0, K, float(lambdad), float(epsn), muu.device.index, stream)
    else:
        fixed = K * K * 8 * muu.element_size() + (0 if patch == 1 else
                                                  chain_frame1_bytes(0, muu.dtype))
        most = _MAX_SMEM_BYTES - fixed
        default = window_budget(K, muu.dtype) if patch == 1 else chain_budget(K, 0, muu.dtype)
        window = default if window_bytes is None else int(window_bytes)
        if not 0 <= window <= most:
            raise ValueError(f"window_bytes must lie in [0, {most}] at K = {K}, got {window}")
        _l1_counts_ok(l1_counts, muu)
        rule = _rule_host(K, muu.dtype)  # held through the call, which copies it
        fn = lib.gqmap_node_chain_v2_f32 if f32 else lib.gqmap_node_chain_v2_f64
        code = fn(I1.data_ptr(), VV.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                  sv.data_ptr(), pn.data_ptr(), rule.ctypes.data, out.data_ptr(),
                  None if l1_counts is None else l1_counts.data_ptr(), Mo, No, L, M, N, r0, c0,
                  K, patch, window, int(bool(generic)), float(lambdad), float(epsn),
                  muu.device.index, stream)
    build.check(code, "node_chain_gq_cuda")
    node_chain_gq_cuda.launches += 1
    return GQChainRaw(*out.unbind(0))


node_chain_gq_cuda.launches = 0


def node_chain_gq(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                  patch: int = 1, origin=None, local_image_shape=None,
                  quad_chunk: int = 0) -> GQChainRaw:
    """Kernel K13 for CUDA tensors, its plain version for CPU tensors."""
    at = dict(patch=patch, origin=origin, local_image_shape=local_image_shape)
    if muu.device.type == "cpu":
        return node_chain_gq_torch(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn,
                                   quad_chunk=quad_chunk, **at)
    return node_chain_gq_cuda(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn, **at)


# --- K16 ---------------------------------------------------------------------------

def node_window_chain_gq_torch(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float,
                               epsn: float, rg: int, origin=None, local_image_shape=None,
                               quad_chunk: int = 0) -> GQChainRaw:
    """Plain version of K16: ``gq_accumulate_chain`` on the windowed bicubic
    node potential with its exact derivatives, ``quad_chunk`` points a step."""
    fg = make_node_pot_windowed_chain(I1, VV, lambdad, epsn, rg, origin=origin,
                                      local_image_shape=local_image_shape)
    return gq_accumulate_chain(fg, muu, muv, su, sv, pn,
                               table_on(K, quad_chunk, False, muu.dtype, muu.device))


def node_window_chain_gq_cuda(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float,
                              epsn: float, rg: int, origin=None, local_image_shape=None,
                              variant: str | None = None, window_bytes: int | None = None,
                              l1_counts: torch.Tensor | None = None,
                              generic: bool = False) -> GQChainRaw:
    """Kernel K16 on the ``(L, M, N)`` sites (one pixel a site) of frame 1's
    block at pixel ``origin`` (the whole frame by default;
    ``local_image_shape`` must be ``(M, N)``), the window's radius ``rg``
    (1 to :data:`MAX_RG`); frame 1 and ``VV`` whole, so a tap across a
    shard's edge reads the true neighbour. ``variant``: None or ``"v1"``,
    its one variant. ``window_bytes``: a CTA's shared-memory budget for its
    window of ``VV`` (None: :func:`chain_budget`; 0 sends every site through
    L1); ``l1_counts``, ``generic`` (the runtime-K instance at float32 K = 9)
    as :func:`node_chain_gq_cuda`'s. Every route and instance gives the same
    sums, bit for bit."""
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    L, M, N = muu.shape
    Mo, No = I1.shape
    site = muu.shape
    build.check_operands("node_window_chain_gq_cuda", muu, (
        ("I1", I1, (Mo, No)), ("VV", VV, (Mo + 2, No + 2)), ("muu", muu, site),
        ("muv", muv, site), ("su", su, site), ("sv", sv, site), ("pn", pn, site)))
    K, rg = int(K), int(rg)
    if not takes("K16", K, muu.dtype, rg=rg):
        raise ValueError(f"K16 takes rules of 1 to {V2_MAX_K} points an axis and window radii "
                         f"1 to {MAX_RG}, not K = {K}, rg = {rg}")
    r0, c0 = _block_at("node_window_chain_gq_cuda", I1, site, 1, origin, local_image_shape)
    resolve_variant("K16", variant, K, muu.dtype, rg=rg)
    most = _MAX_SMEM_BYTES - K * K * 8 * muu.element_size() - chain_frame1_bytes(rg, muu.dtype)
    window = chain_budget(K, rg, muu.dtype) if window_bytes is None else int(window_bytes)
    if not 0 <= window <= most:
        raise ValueError(f"window_bytes must lie in [0, {most}] at K = {K}, rg = {rg}, got "
                         f"{window}")
    _l1_counts_ok(l1_counts, muu)
    out = torch.empty((7,) + site, dtype=muu.dtype, device=muu.device)
    lib = build.library_for(muu.device)
    fn = lib.gqmap_window_chain_f32 if muu.dtype == torch.float32 else lib.gqmap_window_chain_f64
    rule = _rule_host(K, muu.dtype)  # held through the call, which copies it
    build.check(fn(I1.data_ptr(), VV.data_ptr(), muu.data_ptr(), muv.data_ptr(), su.data_ptr(),
                   sv.data_ptr(), pn.data_ptr(), rule.ctypes.data, out.data_ptr(),
                   None if l1_counts is None else l1_counts.data_ptr(), Mo, No, L, M, N, r0, c0,
                   K, rg, window, int(bool(generic)), float(lambdad), float(epsn),
                   muu.device.index, torch.cuda.current_stream(muu.device).cuda_stream),
                "node_window_chain_gq_cuda")
    node_window_chain_gq_cuda.launches += 1
    return GQChainRaw(*out.unbind(0))


node_window_chain_gq_cuda.launches = 0


def node_window_chain_gq(I1, VV, muu, muv, su, sv, pn, K: int, lambdad: float, epsn: float,
                         rg: int, origin=None, local_image_shape=None,
                         quad_chunk: int = 0) -> GQChainRaw:
    """Kernel K16 for CUDA tensors, its plain version for CPU tensors."""
    at = dict(origin=origin, local_image_shape=local_image_shape)
    if muu.device.type == "cpu":
        return node_window_chain_gq_torch(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn, rg,
                                          quad_chunk=quad_chunk, **at)
    return node_window_chain_gq_cuda(I1, VV, muu, muv, su, sv, pn, K, lambdad, epsn, rg, **at)


# --- K14 ---------------------------------------------------------------------------

def edge_chain_gq_torch(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float,
                        quad_chunk: int = 0) -> GQChainRaw:
    """Plain version of K14: ``gq_accumulate_chain`` on the Charbonnier edge
    potential with its exact derivatives, over the ``(D, C, L, M, N)`` edge
    lattice (endpoint 1 ``mu``/``sg``, ``(C, L, M, N)``)."""
    return gq_accumulate_chain(make_edge_pot_chain(lambdas, epsn), mu[None], u2e, sg[None],
                               o2e, rou, table_on(K, quad_chunk, False, mu.dtype, mu.device))


def edge_chain_gq_cuda(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float,
                       variant: str | None = None, generic: bool = False) -> GQChainRaw:
    """Kernel K14, on K3's operands: ``mu``/``sg`` ``(C, L, M, N)``,
    ``u2e``/``o2e``/``rou`` ``(D, C, L, M, N)``. ``variant``: one of
    :data:`VARIANTS` (None: :func:`resolve_variant`); ``"v2"`` takes the
    rule by value for K in :data:`EDGE_V2_K` unless ``generic``, else from
    shared memory. Both variants and instances give the same sums, bit for
    bit."""
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    edge = (D, C, L, M, N)
    build.check_operands("edge_chain_gq_cuda", mu, (
        ("mu", mu, mu.shape), ("sg", sg, mu.shape), ("u2e", u2e, edge), ("o2e", o2e, edge),
        ("rou", rou, edge)))
    K = int(K)
    variant = resolve_variant("K14", variant, K, mu.dtype)
    out = torch.empty((7,) + edge, dtype=mu.dtype, device=mu.device)
    lib = build.library_for(mu.device)
    f32 = mu.dtype == torch.float32
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    ptrs = (mu.data_ptr(), sg.data_ptr(), u2e.data_ptr(), o2e.data_ptr(), rou.data_ptr())
    tail = (out.data_ptr(), D * C, C, L, M * N, K, float(lambdas), float(epsn), mu.device.index,
            stream)
    if variant == "v1":
        rule, _, rule_dev = build.rule_args(paired_chain_rule, K, (), True, mu)
        fn = lib.gqmap_edge_chain_f32 if f32 else lib.gqmap_edge_chain_f64
        code = fn(*ptrs, rule_dev, *tail)
    else:
        rule, rule_host, rule_dev = build.rule_args(paired_chain_rule, K, EDGE_V2_K, generic, mu)
        fn = lib.gqmap_edge_chain_v2_f32 if f32 else lib.gqmap_edge_chain_v2_f64
        code = fn(*ptrs, rule_host, rule_dev, *tail)
    build.check(code, "edge_chain_gq_cuda")
    edge_chain_gq_cuda.launches += 1
    return GQChainRaw(*out.unbind(0))


edge_chain_gq_cuda.launches = 0


def edge_chain_gq(mu, sg, u2e, o2e, rou, K: int, lambdas: float, epsn: float,
                  quad_chunk: int = 0) -> GQChainRaw:
    """Kernel K14 for CUDA tensors, its plain version for CPU tensors."""
    if mu.device.type == "cpu":
        return edge_chain_gq_torch(mu, sg, u2e, o2e, rou, K, lambdas, epsn, quad_chunk)
    return edge_chain_gq_cuda(mu, sg, u2e, o2e, rou, K, lambdas, epsn)


# --- K15 ---------------------------------------------------------------------------

def _crop(fields, M: int, N: int) -> tuple:
    return tuple(x[..., :M, :N] for x in fields)


def edge_diff_adjoint_torch(mu, sg, rou, k1: int, lambdas: float, epsn: float,
                            halo=None) -> tuple:
    """Plain version of K15: ``(Ei, dEi/du1, dEi/do1, dEi/do2, dEi/dp)`` of
    ``gq_ei_diff`` on the Charbonnier difference potential over the ``(2, C,
    L, M, N)`` edge lattice of ``mu``/``sg`` and their neighbours
    (:func:`neighbour_stacks`; ``dEi/du2 = -dEi/du1``); with a ``halo``, on
    the block padded by it (``edge_reduced_gq.pad_halo``), cropped."""
    if halo is not None:
        M, N = mu.shape[-2:]
        return _crop(edge_diff_adjoint_torch(*pad_halo(mu, sg, rou, halo), k1, lambdas, epsn),
                     M, N)
    u2e, o2e = neighbour_stacks(mu, sg)
    sums = gq_ei_diff_adjoint(make_edge_pot_diff_grad(lambdas, epsn), mu[None], u2e, sg[None],
                              o2e, rou, table_on(k1, 0, True, mu.dtype, mu.device))
    ei, du1, _, do1, do2, dp = diff_partials(sums, sg[None], o2e, rou)
    return ei, du1, do1, do2, dp


def edge_diff_adjoint_cuda(mu, sg, rou, k1: int, lambdas: float, epsn: float,
                           halo=None, variant: str | None = None,
                           generic: bool = False) -> tuple:
    """Kernel K15, on K2's operands (``mu``/``sg`` ``(C, L, M, N)``, ``rou``
    ``(2, C, L, M, N)``, the neighbours read in the kernel with wrap); with
    a ``halo``, one launch on the padded block, cropped. ``variant``: one of
    :data:`VARIANTS` (None: :func:`resolve_variant`); ``"v2"`` takes the
    rule by value for K1 in :data:`EDGE_DIFF_V2_K` unless ``generic``, else
    from shared memory. Both variants and instances give the same outputs,
    bit for bit."""
    if halo is not None:
        M, N = mu.shape[-2:]
        return _crop(edge_diff_adjoint_cuda(*pad_halo(mu, sg, rou, halo), k1, lambdas, epsn,
                                            variant=variant, generic=generic), M, N)
    if mu.ndim != 4:
        raise ValueError(f"mu must be (C, L, M, N), got {tuple(mu.shape)}")
    C, L, M, N = mu.shape
    edge = (2, C, L, M, N)
    build.check_operands("edge_diff_adjoint_cuda", mu, (
        ("mu", mu, mu.shape), ("sg", sg, mu.shape), ("rou", rou, edge)))
    k1 = int(k1)
    variant = resolve_variant("K15", variant, k1, mu.dtype)
    out = torch.empty((5,) + edge, dtype=mu.dtype, device=mu.device)
    lib = build.library_for(mu.device)
    f32 = mu.dtype == torch.float32
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    ptrs = (mu.data_ptr(), sg.data_ptr(), rou.data_ptr())
    tail = (out.data_ptr(), C, L, M, N, k1, float(lambdas), float(epsn), mu.device.index, stream)
    # `rule` holds what rule_host or rule_dev points at through the launch
    if variant == "v1":
        rule, _, rule_dev = build.rule_args(paired_rule_1d, k1, (), True, mu)
        fn = lib.gqmap_edge_diff_f32 if f32 else lib.gqmap_edge_diff_f64
        code = fn(*ptrs, rule_dev, *tail)
    else:
        rule, rule_host, rule_dev = build.rule_args(paired_rule_1d, k1, EDGE_DIFF_V2_K, generic,
                                                    mu)
        fn = lib.gqmap_edge_diff_v2_f32 if f32 else lib.gqmap_edge_diff_v2_f64
        code = fn(*ptrs, rule_host, rule_dev, *tail)
    build.check(code, "edge_diff_adjoint_cuda")
    edge_diff_adjoint_cuda.launches += 1
    return tuple(out.unbind(0))


edge_diff_adjoint_cuda.launches = 0


def edge_diff_adjoint(mu, sg, rou, k1: int, lambdas: float, epsn: float, halo=None) -> tuple:
    """Kernel K15 for CUDA tensors, its plain version for CPU tensors."""
    fn = edge_diff_adjoint_torch if mu.device.type == "cpu" else edge_diff_adjoint_cuda
    return fn(mu, sg, rou, k1, lambdas, epsn, halo=halo)


# --- the autograd Functions ---------------------------------------------------------

class Partials(torch.autograd.Function):
    """``fn(*inputs) -> (value, partials)`` as a function ``torch.autograd``
    differentiates: forward runs ``fn`` once (one kernel launch) and keeps
    ``partials``, each the elementwise derivative of ``value`` by one input
    on ``value``'s shape; backward is ``grad * partial``, summed to the
    input's shape where it was broadcast. Nothing reads the host."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        value, partials = fn(*inputs)
        ctx.shapes = [x.shape for x in inputs]
        ctx.save_for_backward(*partials)
        return value

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(
            (grad * d).sum_to_size(shape) if need else None
            for d, shape, need in zip(ctx.saved_tensors, ctx.shapes, ctx.needs_input_grad[1:]))


def chain_ei(sums, u1, u2, o1, o2, p) -> torch.Tensor:
    """``Ei`` (``gq_ei``'s value) of a potential whose chain-rule sums
    ``sums(u1, u2, o1, o2, p) -> GQChainRaw`` come from one launch (K13,
    K14, K16 or their plain versions), differentiable in the five inputs by
    ``chain_partials``."""
    def fn(*site):
        raw = sums(*site)
        return raw.Ei, chain_partials(raw, site[2], site[3], site[4])

    return Partials.apply(fn, u1, u2, o1, o2, p)


class _DiffEi(torch.autograd.Function):
    """K15's ``Ei`` on the ``(2, C, L, M, N)`` edge lattice of ``(mu, sg,
    rou)``; backward scales the saved derivatives by the gradient and sends
    endpoint 2's back to its site by ``roll(x, +1, axis)``, the adjoint of
    the neighbour read (``roll`` the lattice's: ``torch.roll``, or a shard's
    halo roll)."""

    @staticmethod
    def forward(ctx, adjoint, roll, mu, sg, rou):
        ei, du1, do1, do2, dp = adjoint(mu, sg, rou)
        ctx.roll = roll
        ctx.save_for_backward(du1, do1, do2, dp)
        return ei

    @staticmethod
    def backward(ctx, grad):
        du1, do1, do2, dp = ctx.saved_tensors
        roll = ctx.roll

        def back(d1, d2):
            g1, g2 = grad * d1, grad * d2
            return g1.sum(0) + roll(g2[0], 1, -2) + roll(g2[1], 1, -1)

        return None, None, back(du1, -du1), back(do1, do2), grad * dp


def diff_ei(adjoint, mu, sg, rou, roll=torch.roll) -> torch.Tensor:
    """``gq_ei_diff``'s value on the edge lattice of the ``(C, L, M, N)``
    stacks ``mu``, ``sg`` and ``rou``, from ``adjoint(mu, sg, rou) -> (Ei,
    dEi/du1, dEi/do1, dEi/do2, dEi/dp)`` (K15 or its plain version, with the
    shard's halo bound in), differentiable in the three."""
    return _DiffEi.apply(adjoint, roll, mu, sg, rou)
