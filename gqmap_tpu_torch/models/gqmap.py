"""The GQMAP variational inference engine in PyTorch.

Port of ``gqmap_tpu/models/gqmap.py``, with a MAP / logP / AEPE readout at
it=1 and then every ``eval_every`` sweeps. Its two main paths, both with the
Stein estimator and the softmax-natural alpha update:

* ``GQMAPConfig.tpu_fast()``: the closed-form cosine data term (kernel K1)
  and reduced 1-D Charbonnier edge quadrature (kernel K2);
* ``GQMAPConfig.full_mixture()``, the reference-parity exact path: the
  K^2-point bicubic node quadrature (kernel K4) and K^2-point tensor-rule
  Charbonnier edges (kernel K3).

The legacy families run too (``legacy_v1`` .. ``v3``, ``blockmatch_v2``):
the nearest lookup into a 2^rfc-x upsampled frame, the windowed data cost
(``window_rg > 0``, also under the cosine term, whose coefficient field is
then window-meaned), a quadratic node prior toward ``Problem.init_flow``,
truncated-quadratic edges, and the Prewitt (chain-rule) and autodiff
(``torch.autograd`` of the expected energy) gradient estimators. Kernels
launch where the JAX package would run its Pallas kernels: K1 for the
cosine term, K2 / K3 for Charbonnier edges; and where it scans the nearest
lookup (kernel K6, with or without the window), the windowed bicubic term
(kernel K12), the Prewitt chain (kernel K7), the quadratic prior (kernel
K10) and the truncated-quadratic edges under the tensor rule (kernel K11);
the reduced truncated-quadratic edges are the plain ones, as they are the
JAX package's XLA ones. Under the autodiff estimator, where the JAX package
differentiates its XLA scans, one launch gives a term's value and the sums
of its exact derivatives, which a ``torch.autograd.Function`` scales: K1 for
the cosine term, K13 for the bicubic term without a window (one pixel a
site or the super lattice's 4 x 4 blocks), K16 for it with a window, K14
and K15 for the tensor-rule and reduced Charbonnier edges, and K6 for the
nearest lookup's value, whose gradient is zero; the other terms stay
``torch.autograd`` of plain torch.

The Chebyshev data term (``data_term="chebyshev"``,
:mod:`gqmap_tpu_torch.ops.chebyshev`) runs through the K^2-point node
quadrature like the bicubic term, its samples evaluated as a polynomial
series with no gather: kernel K5 under the Stein estimator, where the JAX
package runs its XLA scan.

Both run at full resolution or on the super lattice (``patch > 1``: each
flow node owns a ``patch x patch`` pixel block and its data term is the
block's sum; the presets ``tpu_fast_super`` and ``super_entropy``), with a
synchronous Jacobi sweep (``gqmap_gpu_mixture.m:29-46``) or the red-black
(checkerboard Gauss-Seidel) order, whose two half-steps each evaluate every
term against the other colour's fresh values.

``solve`` also takes ``init_flow``, ``reset_at``, checkpoint / resume and
``out_dir`` (a PNG of the MAP at every readout), as the JAX ``solve`` does,
and ``mesh``: the lattice block-sharded over ``torch.distributed`` ranks,
each running the sweep and its kernels on its own block
(:mod:`gqmap_tpu_torch.parallel`; :class:`DistHooks`).

Differences from the JAX engine, none of which changes a result:

* PyTorch runs eagerly, so there is no jit: on the card the segment runner
  replays a CUDA graph of one predicated sweep and reads the device's sweep
  count and stop flag every :data:`POLL` sweeps (the reference's early stop,
  ``it > its || mean|dmu| < tor``, ``:75``, takes effect on the device
  after the sweep that meets it); on the CPU and with ``mesh`` it is a host
  loop that reads the flag after every sweep.
* T, alpha and the iteration counter stay on the device; the kernels read
  them through pointers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed

from ..config import FlowRange, GQMAPConfig
from ..kernels import COUNTED, build
# the modules of the kernels with a shape limit (_shape_limit)
from ..kernels import autodiff_gq as _k13_k16
from ..kernels import cheb_gq as _k5
from ..kernels import edge_gq as _k3
from ..kernels import edge_reduced_gq as _k2
from ..kernels import nearest_gq as _k6_k7
from ..kernels import node_gq as _k4
from ..kernels import quad_gq as _k10_k11
from ..kernels.autodiff_gq import (chain_ei, diff_ei, edge_chain_gq, edge_chain_gq_cuda,
                                   edge_chain_gq_torch, edge_diff_adjoint, edge_diff_adjoint_cuda,
                                   edge_diff_adjoint_torch, node_chain_gq, node_chain_gq_cuda,
                                   node_chain_gq_torch, node_window_chain_gq,
                                   node_window_chain_gq_cuda, node_window_chain_gq_torch)
from ..kernels.cheb_gq import MAX_Q, cheb_gq, cheb_gq_cuda, cheb_gq_torch
from ..kernels.cosine_gq import (cos_ei_adjoint, cos_mode_sums, cos_mode_sums_cuda,
                                 cos_mode_sums_torch, phase_stack)
from ..kernels.edge_gq import edge_gq, edge_gq_cuda, edge_gq_torch
from ..kernels.edge_reduced_gq import (edge_reduced_grads, edge_reduced_grads_cuda,
                                       edge_reduced_grads_torch, neighbour_stacks)
from ..kernels.nearest_gq import (nearest_chain_gq, nearest_chain_gq_cuda, nearest_chain_gq_torch,
                                  nearest_gq, nearest_gq_cuda, nearest_gq_torch)
from ..kernels.node_gq import node_gq, node_gq_cuda, node_gq_torch
from ..kernels.quad_gq import (quad_node_gq, quad_node_gq_cuda, quad_node_gq_torch,
                               truncquad_edge_gq, truncquad_edge_gq_cuda, truncquad_edge_gq_torch)
from ..kernels import window_gq
from ..kernels.window_gq import node_window_gq, node_window_gq_cuda, node_window_gq_torch
from ..kernels.sweep_update import (MAX_CARRY_L, Carry, EdgeSums, NodeSums, Tail,
                                    lattice_views, site_update_cuda, site_update_torch, stack2,
                                    step_of, step_torch, sweep_tail_cuda, sweep_tail_torch)
from ..ops.chebyshev import ChebData, build_cheb_data, make_node_pot_chebyshev
from ..ops.cosine import CosData, build_cos_data, cos_ei
from ..ops.flowviz import flow_to_color
from ..ops.gq import EDGE, gq_accumulate, gq_accumulate_diff, gq_ei, gq_ei_diff
from ..ops.interp import pad_cubic, prewitt_gradients, upsample_cubic
from ..ops.mixture import extract_map
from ..ops.potentials import (make_edge_pot, make_edge_pot_diff, make_edge_pot_truncquad,
                              make_edge_pot_truncquad_diff, make_node_pot_bicubic,
                              make_node_pot_nearest, make_node_pot_quadratic,
                              make_node_pot_windowed)
from ..ops.quadrature import table_on
from ..ops.simplex import softmax

__all__ = [
    "DistHooks",
    "GQState",
    "Problem",
    "SweepAux",
    "SegmentRunner",
    "SolveResult",
    "check_supported",
    "flow_lattice_shape",
    "init_state",
    "make_problem",
    "make_sweep",
    "make_segment_runner",
    "make_map_fn",
    "make_logp_fn",
    "aepe_of",
    "solve",
]

_NODE_SUMS = {"auto": cos_mode_sums, "cuda": cos_mode_sums_cuda, "torch": cos_mode_sums_torch}
# the bicubic term's K4 route and the Chebyshev term's K5 route (raw sums,
# finalized here)
_NODE_GQ = {"auto": node_gq, "cuda": node_gq_cuda, "torch": node_gq_torch}
_NODE_CHEB = {"auto": cheb_gq, "cuda": cheb_gq_cuda, "torch": cheb_gq_torch}
# the nearest lookup's K6 route and the Prewitt chain's K7 route (raw sums)
_NODE_NEAREST = {"auto": nearest_gq, "cuda": nearest_gq_cuda, "torch": nearest_gq_torch}
_NODE_CHAIN = {"auto": nearest_chain_gq, "cuda": nearest_chain_gq_cuda,
               "torch": nearest_chain_gq_torch}
# the quadratic prior's K10 route (raw sums)
_NODE_QUAD = {"auto": quad_node_gq, "cuda": quad_node_gq_cuda, "torch": quad_node_gq_torch}
# the windowed bicubic term's K12 route (raw sums)
_NODE_WINDOW = {"auto": node_window_gq, "cuda": node_window_gq_cuda,
                "torch": node_window_gq_torch}
# the autodiff estimator's bicubic node term, K13 without a window and K16
# with one (chain-rule sums of its exact derivatives, differentiated by
# autodiff_gq.chain_ei)
_NODE_ADJOINT = {"auto": node_chain_gq, "cuda": node_chain_gq_cuda, "torch": node_chain_gq_torch}
_NODE_WINDOW_ADJOINT = {"auto": node_window_chain_gq, "cuda": node_window_chain_gq_cuda,
                        "torch": node_window_chain_gq_torch}
# the edge term's kernel (_edge_kernel) -> edge_kernel -> its route: K2
# (finalized gradients) or K3 (raw sums, finalized here) of Charbonnier
# edges, K11 (raw sums) of truncated-quadratic tensor-rule edges
_EDGE_ROUTES = {
    "K2": {"auto": edge_reduced_grads, "cuda": edge_reduced_grads_cuda,
           "torch": edge_reduced_grads_torch},
    "K3": {"auto": edge_gq, "cuda": edge_gq_cuda, "torch": edge_gq_torch},
    "K11": {"auto": truncquad_edge_gq, "cuda": truncquad_edge_gq_cuda,
            "torch": truncquad_edge_gq_torch},
    # under the autodiff estimator: K14 (chain-rule sums of tensor-rule
    # Charbonnier edges) and K15 (reduced Charbonnier edges' value and
    # derivatives), differentiated by autodiff_gq.chain_ei and diff_ei
    "K14": {"auto": edge_chain_gq, "cuda": edge_chain_gq_cuda, "torch": edge_chain_gq_torch},
    "K15": {"auto": edge_diff_adjoint, "cuda": edge_diff_adjoint_cuda,
            "torch": edge_diff_adjoint_torch},
}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_E_CONST1 = 1.0 + math.log(2.0 * math.pi)  # entropy constant of a bivariate Gaussian
_INV_PI = 1.0 / math.pi


class GQState(NamedTuple):
    """Variational state: one bivariate Gaussian per (pixel, component), the
    per-edge correlations and the mixture logits (``gqmap_gpu_mixture.m:18-24``)."""

    w: torch.Tensor        # (L,) mixture logits (weights in projsplx mode)
    muu: torch.Tensor      # (L, M, N)
    muv: torch.Tensor      # (L, M, N)
    sigmau: torch.Tensor   # (L, M, N)
    sigmav: torch.Tensor   # (L, M, N)
    pn: torch.Tensor       # (L, M, N) node (u, v) correlation
    rou: torch.Tensor      # (2, 2, L, M, N) edge correlation [direction, channel]
    temperature: torch.Tensor  # () annealed T
    it: torch.Tensor       # () int32, 1-based iteration about to run


class Problem(NamedTuple):
    """Per-run constants on the device."""

    I1: torch.Tensor       # (Mo, No) frame 1
    I2_tab: torch.Tensor   # pad_cubic(I2), or upsample_cubic(I2, rfc) for data_term="nearest"
    interior: torch.Tensor # (M, N) bool: updatable lattice sites
    rng: FlowRange | None
    cheb: CosData | ChebData | None = None  # spectral coefficient field (cosine, chebyshev)
    init_flow: torch.Tensor | None = None  # (M, N, 2) prior flow (data_term="quadratic")
    grad_tabs: tuple | None = None  # upsampled Prewitt fields (gradient_estimator="prewitt")
    # data_term="nearest": pad_cubic(I2) (and pad_cubic of each Prewitt field
    # for gradient_estimator="prewitt"), which kernels K6 and K7 "v2" read in
    # place of the tables
    nearest_pads: tuple | None = None


class SweepAux(NamedTuple):
    energy: torch.Tensor
    ptdmu: torch.Tensor
    ptdsigma: torch.Tensor


def _dt(cfg: GQMAPConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _device(device) -> torch.device:
    """``device``, or the GPU when it is None. With no CUDA device, None
    raises: a CPU run asks for ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def check_supported(cfg: GQMAPConfig) -> None:
    """Raise for a configuration the port does not run.

    Unknown values raise ``ValueError``, as the JAX package's
    ``make_problem`` does, and so does a kernel asked for (``"cuda"``) on a path
    that no kernel computes: K1 computes only the cosine term's sums, K4 only
    the bicubic term's without a window, K12 only the bicubic term's with a
    window (rules up to ``window_gq.MAX_K`` points an axis, radii up to
    ``window_gq.MAX_RG``), K5 only the Chebyshev term's (at most ``MAX_Q``
    v-degrees), K6 only the nearest lookup's (with or without a window), K7
    only the Prewitt chain's, K10 only the quadratic prior's, K2 and K3 only
    Charbonnier edges, K11 only truncated-quadratic edges under the tensor
    rule; under the autodiff estimator K1 the cosine term's, K13 the bicubic
    term's without a window (at patch 1 and 4), K16 the bicubic term's with
    a window, K6 the nearest lookup's value (its index carries no gradient),
    K14 and K15 Charbonnier edges, and every other term is differentiated
    plain torch. ``"cuda"`` also
    raises, naming the limit, where the term's kernel does not take the
    configuration's shape (:func:`_shape_limit`: its rule, v-degrees,
    components or upsampling past what the kernel is built for); ``"auto"``
    runs the plain sums there, as the JAX package runs its scans. K1 takes
    any number of components (in groups of ``cosine_gq.MAX_L``).
    """
    supported = {"data_term": ("cosine", "bicubic", "nearest", "quadratic", "chebyshev"),
                 "edge_quad": ("reduced", "tensor"), "edge_kind": ("charbonnier", "truncquad"),
                 "gradient_estimator": ("stein", "autodiff", "prewitt"),
                 "sweep_order": ("jacobi", "redblack"),
                 "alpha_update": ("softmax_natural", "projsplx"),
                 "node_kernel": tuple(_NODE_SUMS), "edge_kernel": tuple(_NODE_SUMS)}
    for field, ok in supported.items():
        value = getattr(cfg, field)
        if value not in ok:
            raise ValueError(f"unknown {field} {value!r} (expected one of {ok})")
    _dt(cfg)
    for field, term in (("node_kernel", _node_term(cfg)), ("edge_kernel", _edge_term(cfg))):
        limit = None if term is None else _shape_limit(term, cfg)
        if getattr(cfg, field) == "cuda" and limit is not None:
            raise ValueError(f"{field}='cuda' asks for kernel {term}, which does not take this "
                             f"configuration's shape: {limit} (use 'auto', which runs the plain "
                             "sums there, or 'torch')")
    if cfg.node_kernel == "cuda" and _node_term(cfg) is None:
        raise ValueError(
            f"node_kernel='cuda' asks for kernel K1, which computes the cosine data term's "
            f"sums, kernel K4, which computes the bicubic term's without a window, "
            f"kernel K12, which computes the bicubic term's with a window of radius 1 to "
            f"{window_gq.MAX_RG} and rules of at most {window_gq.MAX_K} points an axis, kernel K5, "
            f"which computes the Chebyshev term's with at most {MAX_Q} v-degrees, "
            f"kernel K6, which computes the nearest lookup's, kernel K7, which computes the "
            f"Prewitt chain's, or kernel K10, which computes the quadratic prior's; under the "
            f"autodiff estimator kernel K1, kernel K13, which computes the bicubic term's "
            f"without a window at patch 1 or 4, kernel K16, which computes it with a window "
            f"of radius 1 to {_k13_k16.MAX_RG}, or kernel K6; with data_term={cfg.data_term!r}, "
            f"window_rg={cfg.window_rg}, patch={cfg.patch}, K={cfg.K}, cheb_q={cfg.cheb_q} and "
            f"gradient_estimator={cfg.gradient_estimator!r} the node term is plain torch "
            "(use 'auto' or 'torch')")
    if cfg.edge_kernel == "cuda" and _edge_term(cfg) is None:
        raise ValueError(
            f"edge_kernel='cuda' asks for kernel K2 or K3, which compute Charbonnier edges, "
            f"or kernel K11, which computes truncated-quadratic edges under the tensor rule, "
            f"for the Stein and Prewitt estimators, or kernel K14 or K15, which compute "
            f"Charbonnier edges under the autodiff estimator; with edge_kind="
            f"{cfg.edge_kind!r}, edge_quad={cfg.edge_quad!r} and gradient_estimator="
            f"{cfg.gradient_estimator!r} the edge sums are plain torch (use 'auto' or 'torch')")


def _edge_k1(cfg: GQMAPConfig) -> int:
    """The reduced edges' 1-D rule: ``edge_quad_k`` points, or 2 K + 3."""
    return cfg.edge_quad_k if cfg.edge_quad_k > 0 else 2 * cfg.K + 3


def _shape_limit(kernel: str, cfg: GQMAPConfig) -> str | None:
    """None where ``kernel`` takes ``cfg``'s shape, else the kernel's limit
    and the shape, in words. Each kernel module's ``takes`` is the rule: the
    largest rule a kernel holds (K4, K5, K6, K7, K12, K13, K16: ``MAX_K``
    points an axis), K5's v-degrees and its shared memory a site (L K^2
    samples), K6's and K7's upsampling, K12's and K16's window radius,
    K13's patches, and the generic rule
    instances of K2, K3, K11 (v1), K14 and K15, whose rule must fit a CTA's
    static shared memory. K1 takes every shape (more than
    ``cosine_gq.MAX_L`` components run in groups), K10 every rule."""
    dt = _DTYPES[cfg.dtype]
    K, k1 = cfg.K, _edge_k1(cfg)
    shared = (f"whose paired values fit the generic instance's {build.RULE_SHARED_BYTES} bytes "
              "of shared memory")
    in_dt = f"in {cfg.dtype}"
    limits = {
        "K2": (_k2.takes(k1, dt), f"reduced rules of at least 2 points {shared}",
               f"K1 = {k1} {in_dt}"),
        "K3": (_k3.takes(K, dt), f"rules of at least 2 points an axis {shared}",
               f"K = {K} {in_dt}"),
        "K4": (_k4.takes(K), f"rules of 1 to {_k4.MAX_K} points an axis", f"K = {K}"),
        "K5": (_k5.takes(K, cfg.cheb_q, cfg.L, dt),
               f"rules of 1 to {_k5.MAX_K} points an axis, 1 to {_k5.MAX_Q} v-degrees and a "
               f"site's L K^2 samples within {_k5._MAX_SMEM_BYTES} bytes of shared memory",
               f"K = {K}, cheb_q = {cfg.cheb_q}, L = {cfg.L} {in_dt}"),
        "K6": (_k6_k7.takes(K, cfg.rfc), f"rules of 1 to {_k6_k7.MAX_K} points an axis and rfc "
               f"of at most {_k6_k7.MAX_RFC}", f"K = {K}, rfc = {cfg.rfc}"),
        "K10": (_k10_k11.takes("K10", K, dt), "rules of at least 1 point", f"K = {K}"),
        "K11": (_k10_k11.takes("K11", K, dt), f"rules of 2 to {_k10_k11.V2_MAX_K} points an "
                f"axis, or more whose v1 rule (K + 4 K^2 values) fits {build.RULE_SHARED_BYTES} "
                "bytes of shared memory", f"K = {K} {in_dt}"),
        "K12": (window_gq.takes(K, cfg.window_rg), f"rules of 1 to {window_gq.MAX_K} points an "
                f"axis and window radii 1 to {window_gq.MAX_RG}",
                f"K = {K}, window_rg = {cfg.window_rg}"),
        "K13": (_k13_k16.takes("K13", K, dt, patch=cfg.patch),
                f"patch in {_k13_k16.CHAIN_PATCHES} and rules of 1 to {_k13_k16.MAX_K} points an "
                f"axis at patch 1, 1 to {_k4.V2_MAX_K} at patch 4",
                f"patch = {cfg.patch}, K = {K}"),
        "K16": (_k13_k16.takes("K16", K, dt, rg=cfg.window_rg),
                f"rules of 1 to {_k4.V2_MAX_K} points an axis and window radii 1 to "
                f"{_k13_k16.MAX_RG}", f"K = {K}, window_rg = {cfg.window_rg}"),
        "K14": (_k13_k16.takes("K14", K, dt), f"rules {shared}", f"K = {K} {in_dt}"),
        "K15": (_k13_k16.takes("K15", k1, dt), f"reduced rules {shared}", f"K1 = {k1} {in_dt}"),
    }
    limits["K7"] = limits["K6"]
    if kernel not in limits or limits[kernel][0]:
        return None
    _, limit, shape = limits[kernel]
    return f"{kernel} takes {limit}, not {shape}"


def _node_term(cfg: GQMAPConfig) -> str | None:
    """The kernel that computes ``cfg``'s node term, whatever its shape,
    under the Stein and Prewitt estimators: ``"K1"`` (the cosine term),
    ``"K4"`` (the bicubic term without a window), ``"K12"`` (the bicubic
    term with a window), ``"K5"`` (the Chebyshev term, whose window is in
    its coefficients), ``"K6"`` (the nearest lookup, with or without a
    window), ``"K7"`` (the Prewitt estimator's chain on the nearest lookup),
    ``"K10"`` (the quadratic prior toward ``Problem.init_flow``), or None
    where the sums are plain torch. Under the autodiff estimator: ``"K1"``
    (the cosine term, whose mode sums are its exact gradient), ``"K13"``
    (the bicubic term without a window), ``"K16"`` (the bicubic term with a
    window), ``"K6"`` (the nearest lookup's value: its index is a floor, so
    its gradient is zero), else None."""
    if cfg.gradient_estimator == "autodiff":
        if cfg.data_term in ("cosine", "nearest"):
            return {"cosine": "K1", "nearest": "K6"}[cfg.data_term]
        if cfg.data_term == "bicubic":
            return "K13" if cfg.window_rg == 0 else "K16"
        return None
    if cfg.gradient_estimator == "prewitt":
        return "K7" if cfg.data_term == "nearest" else None
    if cfg.data_term == "bicubic":
        return "K4" if cfg.window_rg == 0 else "K12"
    return {"nearest": "K6", "cosine": "K1", "chebyshev": "K5",
            "quadratic": "K10"}.get(cfg.data_term)


def _node_kernel(cfg: GQMAPConfig) -> str | None:
    """:func:`_node_term`'s kernel where it takes ``cfg``'s shape
    (:func:`_shape_limit`), else None: the node sums are then plain torch."""
    kernel = _node_term(cfg)
    return None if kernel is None or _shape_limit(kernel, cfg) else kernel


def _edge_term(cfg: GQMAPConfig) -> str | None:
    """The kernel that computes ``cfg``'s edge term, whatever its shape,
    under the Stein and Prewitt estimators: ``"K2"`` (reduced Charbonnier
    edges), ``"K3"`` (tensor-rule Charbonnier edges), ``"K11"`` (tensor-rule
    truncated-quadratic edges), or None where the sums are plain torch (the
    reduced truncated-quadratic edges). Under the autodiff estimator:
    ``"K15"`` (reduced Charbonnier edges), ``"K14"`` (tensor-rule Charbonnier
    edges), else None."""
    if cfg.gradient_estimator == "autodiff":
        if cfg.edge_kind != "charbonnier":
            return None
        return "K15" if cfg.edge_quad == "reduced" else "K14"
    if cfg.edge_kind == "charbonnier":
        return "K2" if cfg.edge_quad == "reduced" else "K3"
    return "K11" if cfg.edge_quad == "tensor" else None


def _edge_kernel(cfg: GQMAPConfig) -> str | None:
    """:func:`_edge_term`'s kernel where it takes ``cfg``'s shape
    (:func:`_shape_limit`), else None: the edge sums are then plain torch."""
    kernel = _edge_term(cfg)
    return None if kernel is None or _shape_limit(kernel, cfg) else kernel


def flow_lattice_shape(cfg: GQMAPConfig, image_shape) -> tuple[int, int]:
    Mo, No = image_shape
    if Mo % cfg.patch or No % cfg.patch:
        raise ValueError(f"image shape {image_shape} not divisible by patch={cfg.patch}")
    return Mo // cfg.patch, No // cfg.patch


def _interior_mask(M: int, N: int, border: int) -> np.ndarray:
    m = np.zeros((M, N), bool)
    m[border:M - border, border:N - border] = True
    return m


def make_problem(cfg: GQMAPConfig, I1, I2, flow_range: FlowRange | None = None,
                 device=None) -> Problem:
    """Frames on the device and the frame-2 table of the data term:
    ``pad_cubic(I2)``, or ``upsample_cubic(I2, rfc)`` for ``"nearest"`` (and
    its two upsampled Prewitt fields for the Prewitt estimator); for
    ``data_term="cosine"`` or ``"chebyshev"`` also the spectral coefficient
    field over the flow range widened by ``cheb_margin``. ``Problem.init_flow``,
    the prior of ``data_term="quadratic"``, is the caller's to set
    (``problem._replace(init_flow=...)``), as in the JAX package."""
    if cfg.window_rg > 0 and cfg.patch > 1:
        raise ValueError("window_rg and patch > 1 are mutually exclusive")
    if cfg.gradient_estimator == "prewitt" and cfg.data_term != "nearest":
        raise ValueError("gradient_estimator='prewitt' requires data_term='nearest'")
    check_supported(cfg)
    spectral = {"cosine": build_cos_data, "chebyshev": build_cheb_data}.get(cfg.data_term)
    if spectral is not None and flow_range is None:
        raise ValueError(f"data_term={cfg.data_term!r} needs flow_range at make_problem")
    dt, device = _dt(cfg), _device(device)
    # contiguous whatever the caller's strides (a cropped frame): kernel K4 reads them flat
    I1 = torch.as_tensor(np.asarray(I1), dtype=dt, device=device).contiguous()
    I2 = torch.as_tensor(np.asarray(I2), dtype=dt, device=device).contiguous()
    tab = upsample_cubic(I2, cfg.rfc) if cfg.data_term == "nearest" else pad_cubic(I2)
    cheb = grad_tabs = pads = None
    if cfg.data_term == "nearest":
        pads = (pad_cubic(I2),)
    if spectral is not None:
        m = cfg.cheb_margin
        box = (flow_range.minu - m, flow_range.maxu + m,
               flow_range.minv - m, flow_range.maxv + m)
        cheb = spectral(I1, tab, cfg.lambdad, cfg.epsn, box, cfg.cheb_p, cfg.cheb_q,
                        patch=cfg.patch, window_rg=cfg.window_rg)
    if cfg.gradient_estimator == "prewitt":
        grads = prewitt_gradients(I2)
        grad_tabs = tuple(upsample_cubic(G, cfg.rfc) for G in grads)
        pads += tuple(pad_cubic(G) for G in grads)
    M, N = flow_lattice_shape(cfg, I1.shape)
    interior = torch.as_tensor(_interior_mask(M, N, cfg.border), device=device)
    return Problem(I1=I1, I2_tab=tab, interior=interior, rng=flow_range, cheb=cheb,
                   grad_tabs=grad_tabs, nearest_pads=pads)


def init_state(cfg: GQMAPConfig, rng: FlowRange, image_shape, seed=None,
               device=None) -> GQState:
    """Random init mirroring ``gqmap_gpu_mixture.m:18-24``: uniforms over the
    flow range, wide sigmas, zero correlations. Drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (default ``cfg.seed``), so a seed
    gives the same state on every device; the bits differ from
    ``jax.random``'s."""
    dt, device = _dt(cfg), _device(device)
    M, N = flow_lattice_shape(cfg, image_shape)
    L = cfg.L
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, dtype=dt)

    du = rng.maxu - rng.minu
    dv = rng.maxv - rng.minv
    w0 = uniform(L)
    if cfg.alpha_update != "softmax_natural":
        w0 = softmax(w0)  # projsplx mode stores the weights themselves
    state = GQState(
        w=w0,
        muu=rng.minu + uniform(L, M, N) * du,
        muv=rng.minv + uniform(L, M, N) * dv,
        sigmau=uniform(L, M, N) + du,
        sigmav=uniform(L, M, N) + dv,
        pn=torch.zeros((L, M, N), dtype=dt),
        rou=torch.zeros((2, 2, L, M, N), dtype=dt),
        temperature=torch.tensor(cfg.temperature, dtype=dt),
        it=torch.tensor(1, dtype=torch.int32),
    )
    return GQState(*(x.to(device) for x in state))


def _node_f(cfg: GQMAPConfig, problem: Problem, origin=None, local_image_shape=None):
    """The data term's potential ``f(x1, x2)`` (None for the closed-form
    cosine term, which has no per-sample potential). On a shard, ``origin``
    and ``local_image_shape`` are its block's pixel offset and extent; the
    spectral fields and the quadratic prior's init flow are per site and
    arrive as the block's own."""
    if cfg.data_term == "cosine":
        return None
    if cfg.data_term == "quadratic":
        return make_node_pot_quadratic(_prior(problem), cfg.quad_var)
    if cfg.data_term == "chebyshev":
        return make_node_pot_chebyshev(problem.cheb, cfg.cheb_ablock)
    at = dict(origin=origin, local_image_shape=local_image_shape)
    if cfg.window_rg > 0:
        return make_node_pot_windowed(problem.I1, problem.I2_tab, cfg.lambdad, cfg.epsn,
                                      cfg.window_rg, cfg.data_term, cfg.rfc, **at)
    if cfg.data_term == "bicubic":
        return make_node_pot_bicubic(problem.I1, problem.I2_tab, cfg.lambdad, cfg.epsn,
                                     patch=cfg.patch, **at)
    return make_node_pot_nearest(problem.I1, problem.I2_tab, cfg.lambdad, cfg.epsn, cfg.rfc,
                                 **at)


def _prior(problem: Problem) -> torch.Tensor:
    """The quadratic prior's ``(M, N, 2)`` flow, ``Problem.init_flow``, in the
    frames' type and on their device (no copy where it is already so)."""
    if problem.init_flow is None:
        # the JAX package fails here too, with a TypeError: its solve(init_flow=...)
        # also seeds only the means (ROADMAP Queue 3, F4)
        raise ValueError("data_term='quadratic' needs Problem.init_flow, the (M, N, 2) "
                         "prior flow: set it with problem._replace(init_flow=...); "
                         "solve(init_flow=...) seeds only the means")
    return torch.as_tensor(problem.init_flow, dtype=problem.I1.dtype, device=problem.I1.device)


class DistHooks(NamedTuple):
    """Hooks that turn the single-device sweep into the sweep of one shard
    (``parallel.halo.make_halo_sweep``).

    ``roll(x, shift, axis)`` is the global circshift over the sharded
    lattice (a halo exchange); ``psum`` the sum of a small vector over the
    shards; ``origin()`` the lattice offset (row, column) of this shard and
    ``local_lattice`` its extent; ``halo(x)`` the ``(down, right)`` slices
    of ``x`` one row below and one column to the right of the block, which
    kernel K2 reads in place of its wrap.
    """

    roll: Callable
    psum: Callable
    origin: Callable
    local_lattice: tuple
    halo: Callable


def _update_route(cfg: GQMAPConfig, dist: DistHooks | None, device) -> str:
    """The route of the sweep's update around the node and edge kernels:
    ``"K8"``, kernels K8 and K9 (``kernels/sweep_update``), for every
    single-device Stein or Prewitt sweep on a CUDA device whose node term is
    not asked for in plain torch (``node_kernel != "torch"``), at any L;
    else ``"plain"``, their plain versions: on the CPU, for
    ``node_kernel="torch"``, the autodiff estimator (whose gradients come
    from ``torch.autograd``) and a mesh (whose rolls and sums are host
    collectives)."""
    if (torch.device(device).type == "cuda" and dist is None and cfg.node_kernel != "torch"
            and cfg.gradient_estimator != "autodiff"):
        return "K8"
    return "plain"


# the K8 route's kernels (site update, sweep tail) and K8's variant: "v2" runs
# K9's work in K8's last CTA and, on the device loop, writes the carry;
# "v1" launches K9 after K8
_UPDATE = {"K8": (site_update_cuda, sweep_tail_cuda)}
UPDATE_VARIANT = {"K8": "v2"}
_LATTICE = ("muu", "muv", "sigmau", "sigmav", "pn", "rou")


def make_sweep(cfg: GQMAPConfig, image_shape, dist: DistHooks | None = None):
    """Build the single-sweep update: ``sweep(problem, state, active=None,
    loop=None) -> (state, SweepAux)``. ``sweep_order="jacobi"`` is one
    synchronous step over the interior; ``"redblack"`` is a step over the
    interior's red sites (``(row + col)`` even, in global lattice
    coordinates) and then one over its black sites from the red step's
    state, so every kernel launches twice a sweep. Energy and the alpha
    gradient come from the second half.

    The kernels' routes follow the JAX package's rule: K1 for the cosine
    term and K2 / K3 for Charbonnier edges under the Stein and Prewitt
    estimators; K4 for the bicubic term without a window, K12 for it with
    a window, K5 for the Chebyshev term, K6 for the nearest lookup (with or
    without a window) and K10 for the quadratic prior under the Stein
    estimator, K7 for the Prewitt estimator's chain sums and K11 for
    truncated-quadratic edges under the tensor rule (each of which the JAX
    package runs as one XLA scan); a shape its kernel does not take
    (:func:`_shape_limit`: ``cheb_q > MAX_Q``, a rule past a kernel's
    largest, a window radius K12 does not take, ...) runs that kernel's
    plain version, and the reduced truncated-quadratic edges run plain sums
    (:func:`check_supported` refuses ``"cuda"`` there). Under the autodiff
    estimator K1, K13, K16, K6, K14
    and K15 compute the terms :func:`_node_kernel` and :func:`_edge_kernel`
    name, inside ``torch.autograd.Function``s (``node_kernel`` or
    ``edge_kernel`` ``"torch"``: ``torch.autograd`` of the plain expectation),
    and the other terms are differentiated plain torch. What the JAX
    package fuses around them (the finalize of the raw sums, the neighbour
    assembly, the clamped step, the reductions, the alpha update and the
    counter) runs as kernels K8 and K9 where :func:`_update_route` names
    them, else as their plain versions; the new state is the same bit for
    bit either way, and the sums differ in their order.

    With ``dist`` the sweep is one shard's: ``problem`` and ``state`` hold
    its block, every neighbour roll goes through ``dist.roll``, K2 reads the
    ``dist.halo`` of its block, the red mask takes the block's origin, and
    each pass's energy, alpha gradient and |dmu| / |dsigma| sums are summed
    over the shards in one ``dist.psum``; ``n_interior`` stays the whole
    lattice's.

    ``active``, a boolean tensor of no dimensions on the state's device,
    predicates the sweep on the device: it joins the site mask of the
    clamped step and gates the mixture weights, the temperature and the
    iteration counter. Where it is true the sweep computes what it computes
    without it, bit for bit; where it is false the state comes back
    unchanged, with no host read either way. ``loop = (n, stop, bufs,
    planes)`` makes the sweep the segment runner's predicated step
    (:func:`_predicated_step`), predicated on ``~stop``: ``state``, whose
    lattice fields are the :func:`lattice_views` of the ``(9, L, M, N)``
    buffer ``planes``, is updated in place and returned, and, where the
    sweep ran, its traces go to slot ``n`` of the ``(3, cap)`` traces
    ``bufs``, the reference's stop rule (``it > its || ptdmu < tor``,
    ``gqmap_gpu_mixture.m:75``) may set ``stop`` and ``n`` advances. A fifth
    entry of ``loop``, a :class:`~gqmap_tpu_torch.kernels.sweep_update.Carry`
    (``sweep.carry(problem, state)`` builds it), is what the last sweep's K8
    v2 wrote for this one: the step, alpha, K1's phase stack and the raw
    edges' neighbour stacks, read in place of their torch expressions; K8
    v2 then rewrites it, and for K2's gradients writes the new lattice into
    ``planes`` itself. The sweep returned also has ``sweep.carry``."""
    check_supported(cfg)
    dt = _dt(cfg)
    M, N = flow_lattice_shape(cfg, image_shape)
    L = cfg.L
    b = cfg.border
    k1 = _edge_k1(cfg)
    n_interior = (M - 2 * b) * (N - 2 * b) * L
    softmax_mode = cfg.alpha_update == "softmax_natural"
    node_sums_fn = _NODE_SUMS[cfg.node_kernel]
    autodiff = cfg.gradient_estimator == "autodiff"
    # K4, K5, K6, K7, K10 or K12 (or its plain version) where the JAX package scans
    # the bicubic term, the Chebyshev series, the nearest lookup, the Prewitt
    # chain, the quadratic prior or the windowed bicubic term
    # (and under the autodiff estimator K13, K16, or K6 for the nearest lookup's
    # value; node_kernel="torch" there is torch.autograd of the plain expectation)
    # (a shape the kernel does not take runs its plain version, the "torch" route)
    routes = {"K4": _NODE_GQ, "K5": _NODE_CHEB, "K6": _NODE_NEAREST, "K7": _NODE_CHAIN,
              "K10": _NODE_QUAD, "K12": _NODE_WINDOW, "K13": _NODE_ADJOINT,
              "K16": _NODE_WINDOW_ADJOINT}
    kernel = _node_term(cfg)
    node_via = cfg.node_kernel if _node_kernel(cfg) is not None else "torch"
    if autodiff and node_via == "torch":
        kernel = None
    node_route = routes[kernel][node_via] if kernel in routes else None
    if node_route is not None and node_via != "cuda":
        # the plain versions step quad_chunk points at a time; the kernels take all
        node_route = functools.partial(node_route, quad_chunk=cfg.quad_chunk)
    reduced = cfg.edge_quad == "reduced"
    if cfg.edge_kind == "truncquad":
        edge_f = make_edge_pot_truncquad(cfg.gama, cfg.dta)
        edge_fd = make_edge_pot_truncquad_diff(cfg.gama, cfg.dta)
        edge_par = (cfg.gama, cfg.dta)
    else:
        edge_f = make_edge_pot(cfg.lambdas, cfg.epsn)
        edge_fd = make_edge_pot_diff(cfg.lambdas, cfg.epsn)
        edge_par = (cfg.lambdas, cfg.epsn)
    # K2 or K3 where the JAX package runs its Pallas edge kernels, K11 where it
    # scans truncated-quadratic tensor-rule edges, else the plain sums; under
    # the autodiff estimator K14 or K15 (edge_kernel="torch": torch.autograd of
    # the plain expectation)
    # (a shape the kernel does not take runs its plain version, the "torch" route)
    edge_kernel = _edge_term(cfg)
    edge_via = cfg.edge_kernel if _edge_kernel(cfg) is not None else "torch"
    if autodiff and edge_via == "torch":
        edge_kernel = None
    edge_route = None if edge_kernel is None else _EDGE_ROUTES[edge_kernel][edge_via]
    if edge_kernel in ("K11", "K14") and edge_via != "cuda":
        # K11's and K14's plain versions step quad_chunk points at a time
        edge_route = functools.partial(edge_route, quad_chunk=cfg.quad_chunk)
    roll = torch.roll if dist is None else dist.roll
    node_at = {}
    r0 = c0 = 0
    ml, nl = M, N
    if dist is not None:
        r0, c0 = dist.origin()
        ml, nl = dist.local_lattice
        node_at = dict(origin=(r0 * cfg.patch, c0 * cfg.patch),
                       local_image_shape=(ml * cfg.patch, nl * cfg.patch))
    # parity in global lattice coordinates, so the order is shard-invariant
    red_np = (np.add.outer(np.arange(ml) + r0, np.arange(nl) + c0) & 1) == 0
    red_on = {}  # device -> the red mask there
    redblack = cfg.sweep_order == "redblack"
    # the node and edge forms K8 sees: K1's mode sums; K2's gradients (else
    # raw sums over neighbour stacks)
    modes_node = cfg.gradient_estimator != "prewitt" and cfg.data_term == "cosine"
    grads_edges = edge_route is not None and reduced and not autodiff
    carry_alpha = softmax_mode and L <= MAX_CARRY_L

    def carry_of(problem: Problem, state: GQState, into: Carry | None = None):
        """The device loop's carry for ``state`` by the plain expressions
        (None off the K8 v2 route); ``into``, an earlier carry whose buffers a
        graph reads, is rewritten in place and returned, whatever the route
        now (the graph keeps the one it was captured on)."""
        route = _update_route(cfg, dist, state.muu.device)
        if into is None and (route == "plain" or UPDATE_VARIANT[route] != "v2"):
            return None
        new = Carry(step_of(state.it, cfg, dt), softmax(state.w) if carry_alpha else None)
        if modes_node:
            new = new._replace(stack=phase_stack(problem.cheb, state.muu, state.muv,
                                                 state.sigmau, state.sigmav, state.pn))
        if not grads_edges:
            u2e, o2e = neighbour_stacks(stack2(state.muu, state.muv),
                                        stack2(state.sigmau, state.sigmav), roll)
            new = new._replace(u2e=u2e, o2e=o2e)
        if into is None:
            return Carry(*(None if x is None else x.contiguous() for x in new))
        for dst, src in zip(into, new):
            if dst is not None:
                dst.copy_(src)
        return into

    def sweep(problem: Problem, state: GQState, active=None,
              loop=None) -> tuple[GQState, SweepAux]:
        if loop is not None and active is not None:
            raise ValueError("the device loop's predicate is its stop flag: pass no active")
        rngv = problem.rng
        interior = problem.interior  # (M, N), broadcasts left
        route = _update_route(cfg, dist, interior.device)
        if loop is not None and route == "plain":
            active = ~loop[1]
        v2 = route != "plain" and UPDATE_VARIANT[route] == "v2"
        carry = loop[4] if v2 and loop is not None and len(loop) > 4 else None
        node_tab = table_on(cfg.K, cfg.quad_chunk, False, dt, interior.device)
        tab1 = table_on(k1, 0, True, dt, interior.device)
        step = step_of(state.it, cfg, dt) if carry is None else carry.step
        if carry is not None and carry.alpha is not None:
            alpha = carry.alpha
        else:
            alpha = softmax(state.w) if softmax_mode else state.w
        a3 = alpha.reshape(L, 1, 1)
        T = state.temperature

        node_f = None if node_route is not None else _node_f(cfg, problem, **node_at)

        def autodiff_grads(st: GQState):
            """The autodiff estimator (heir of ``legacy/gqmap_gpuV3.m``): every
            parameter gradient, the neighbour scatter-back included, by
            ``torch.autograd`` of the quadrature-estimated expected energy of
            the full lattice (border-owned and wrap-around edges too: what the
            reference's assembled gradients differentiate); the energy and
            dalpha it reports are the interior's (``gqmap_gpu_mixture.m:36,48``).
            Where a kernel computes a term (K1, K13, K14, K15, K16, or its
            plain version), one launch gives its value and the sums of its exact
            derivatives, a ``torch.autograd.Function``; the nearest lookup's
            value comes from K6, with no gradient, as under ``jax.grad``."""
            zero = torch.zeros((), dtype=dt, device=interior.device)
            leaves = [x.detach().requires_grad_() for x in
                      (st.muu, st.muv, st.sigmau, st.sigmav, st.pn, st.rou)]
            muu, muv, su, sv, pn, rou = leaves
            site = (muu, muv, su, sv, pn)
            with torch.enable_grad():
                if cfg.data_term == "cosine" and cfg.node_kernel == "torch":
                    en = cos_ei(problem.cheb, *site)
                elif cfg.data_term == "cosine":  # kernel K1
                    en = cos_ei_adjoint(problem.cheb, *site, sums=node_sums_fn)
                elif kernel == "K6":  # the lookup's index is a floor: no gradient
                    with torch.no_grad():
                        en = node_sums(st).fields[0] * _INV_PI
                elif kernel == "K13":  # frame 1 and VV whole, addressed at the block's origin
                    at = node_at if cfg.patch == 1 else {**node_at, "patch": cfg.patch}
                    en = chain_ei(lambda *x: node_route(problem.I1, problem.I2_tab, *x, cfg.K,
                                                        cfg.lambdad, cfg.epsn, **at),
                                  *site) * _INV_PI
                elif kernel == "K16":
                    en = chain_ei(lambda *x: node_route(problem.I1, problem.I2_tab, *x, cfg.K,
                                                        cfg.lambdad, cfg.epsn, cfg.window_rg,
                                                        **node_at), *site) * _INV_PI
                else:
                    en = gq_ei(node_f, *site, node_tab) * _INV_PI
                da_n = en - 3.0 * T * (_E_CONST1 + torch.log(torch.sqrt(1.0 - pn * pn) * su * sv))
                mu = torch.stack([muu, muv])
                sg = torch.stack([su, sv])
                u2e, o2e = neighbour_stacks(mu, sg, roll)
                if edge_kernel == "K15":  # the kernel reads the neighbours (a shard's halo)
                    halo = None if dist is None else dist.halo(torch.stack([mu, sg]).detach())
                    ei_e = diff_ei(lambda m, s, r: edge_route(m, s, r, k1, cfg.lambdas, cfg.epsn,
                                                              halo=halo), mu, sg, rou, roll)
                elif edge_kernel == "K14":
                    ei_e = chain_ei(lambda u1, u2, o1, o2, p: edge_route(
                        u1[0], o1[0], u2, o2, p, cfg.K, cfg.lambdas, cfg.epsn),
                        mu[None], u2e, sg[None], o2e, rou)
                elif reduced:
                    ei_e = gq_ei_diff(edge_fd, mu[None], u2e, sg[None], o2e, rou, tab1)
                else:
                    ei_e = gq_ei(edge_f, mu[None], u2e, sg[None], o2e, rou, node_tab)
                He = _E_CONST1 + torch.log(torch.sqrt(1.0 - rou * rou) * sg[None] * o2e)
                da_e = ei_e * _INV_PI + T * He
                full = (a3 * da_n).sum() + (a3 * da_e).sum()
                grads = torch.autograd.grad(full, leaves)
            da_n, da_e = da_n.detach(), da_e.detach()
            energy = (torch.where(interior, a3 * da_n, zero).sum()
                      + torch.where(interior, a3 * da_e, zero).sum())
            dalpha = (torch.where(interior, da_n, zero).sum((-2, -1))
                      + torch.where(interior, da_e, zero).sum((0, 1, -2, -1)))
            return grads, energy, dalpha

        def node_sums(st: GQState) -> NodeSums:
            """The node term's raw output (gqmap_gpu_mixture.m:29, :87-116)."""
            if cfg.gradient_estimator == "prewitt":  # kernel K7
                # quadrature of the chain-rule df/dx against the upsampled
                # Prewitt fields (legacy/gqmap_gpuV3.m:91-125)
                chain_at = {} if dist is None else dict(origin=(r0, c0),
                                                        local_image_shape=(ml, nl))
                raw_c = node_route(problem.I1, problem.I2_tab, *problem.grad_tabs, st.muu, st.muv,
                                   st.sigmau, st.sigmav, st.pn, cfg.K, cfg.lambdad, cfg.epsn,
                                   cfg.rfc, pads=problem.nearest_pads, **chain_at)
                return NodeSums("chain", tuple(raw_c))
            if cfg.data_term == "cosine":  # kernel K1
                at = {} if carry is None or carry.stack is None else {"stack": carry.stack}
                sums = node_sums_fn(problem.cheb, st.muu, st.muv, st.sigmau, st.sigmav, st.pn,
                                    **at)
                return NodeSums("modes", tuple(sums), problem.cheb)
            # the K^2-point node quadrature: kernel K4, K5, K6, K10 or K12, else plain torch
            site = (st.muu, st.muv, st.sigmau, st.sigmav, st.pn)
            if kernel == "K4":
                raw_n = node_route(problem.I1, problem.I2_tab, *site, cfg.K, cfg.lambdad,
                                   cfg.epsn, patch=cfg.patch, **node_at)
            elif kernel == "K12":  # frame 1 and VV whole, addressed at the block's origin
                raw_n = node_route(problem.I1, problem.I2_tab, *site, cfg.K, cfg.lambdad,
                                   cfg.epsn, cfg.window_rg, **node_at)
            elif kernel == "K5":  # the field is the shard's own block
                raw_n = node_route(problem.cheb, *site, cfg.K)
            elif kernel == "K6":
                raw_n = node_route(problem.I1, problem.I2_tab, *site, cfg.K, cfg.lambdad,
                                   cfg.epsn, cfg.rfc, cfg.window_rg,
                                   pads=problem.nearest_pads, **node_at)
            elif kernel == "K10":  # the prior is the shard's own block
                raw_n = node_route(_prior(problem), *site, cfg.K, cfg.quad_var)
            else:
                raw_n = gq_accumulate(node_f, *site, node_tab)
            return NodeSums("raw", tuple(raw_n))

        def edge_sums(st: GQState) -> EdgeSums:
            """The edge term's output (:31-34, :118-146); dims (dir, chan, L, M, N)."""
            mu = stack2(st.muu, st.muv)
            sg = stack2(st.sigmau, st.sigmav)
            if not grads_edges:  # raw sums on the neighbour stacks (or their carry)
                if carry is None or carry.u2e is None:
                    u2e, o2e = neighbour_stacks(mu, sg, roll)
                else:
                    u2e, o2e = carry.u2e, carry.o2e
            if edge_route is None:  # reduced truncated-quadratic edges, plain torch
                raw_e = gq_accumulate_diff(edge_fd, mu[None], u2e, sg[None], o2e, st.rou, tab1)
                return EdgeSums("raw", tuple(raw_e), o2e)
            if reduced:  # kernel K2, which reads the neighbour itself; its E is alpha * da
                halo = None if dist is None else dist.halo(torch.stack([mu, sg]))
                ge = edge_route(mu, sg, st.rou, alpha, T, k1, cfg.lambdas, cfg.epsn, EDGE,
                                halo=halo)
                return EdgeSums("grads", tuple(ge)[:6])
            raw_e = edge_route(mu, sg, u2e, o2e, st.rou, cfg.K, *edge_par)  # K3 or K11
            return EdgeSums("raw", tuple(raw_e), o2e)

        if route != "plain":  # kernel K8 each pass; K9 in v2's last pass, or after it
            site_update, sweep_tail = _UPDATE[route]
            stop = None if loop is None else loop[1]
            st, parts, res = state, [], None
            colours = (0, 1) if redblack else (None,)
            for colour in colours:
                kw = {}
                if v2:
                    kw = dict(variant="v2", carry=carry,
                              out=loop[3] if carry is not None and grads_edges else None)
                    if colour == colours[-1]:
                        kw["tail"] = Tail(state, n_interior, parts[0] if parts else None,
                                          None if loop is None else loop[:3])
                res = site_update(node_sums(st), edge_sums(st), st, alpha, T, step, interior,
                                  cfg, rngv, colour=colour, active=active, stop=stop, **kw)
                planes, part = res[:2]
                st = st._replace(**dict(zip(_LATTICE, lattice_views(planes))))
                parts.append(part)
            if v2:
                w, T, it, aux = res[2]
            else:
                w, T, it, aux = sweep_tail(parts, state, step, cfg, n_interior, active=active,
                                           loop=None if loop is None else loop[:3])
            if loop is None:
                return st._replace(w=w, temperature=T, it=it), SweepAux(*aux[:3])
            if planes is not loop[3]:  # w, T and it are already state's; the lattice comes back
                loop[3].copy_(planes)
            return state, SweepAux(*aux[:3])

        def one_pass(st: GQState, mask):
            """One pass of the plain glue over a site mask: the state with its
            new lattice fields and (energy, dalpha, sum |dmu|, sum |dsigma|)."""
            if autodiff:
                grads, energy, dalpha = autodiff_grads(st)
                st2, dmu_sum, dsig_sum = step_torch(st, grads, step, mask, cfg, rngv)
            else:
                st2, (energy, dalpha, dmu_sum, dsig_sum) = site_update_torch(
                    node_sums(st), edge_sums(st), st, alpha, T, step, interior, mask, cfg,
                    rngv, roll)
            if dist is not None:  # one reduction a pass over the shards
                v = dist.psum(torch.cat([energy.reshape(1), dalpha.reshape(L),
                                         dmu_sum.reshape(1), dsig_sum.reshape(1)]))
                energy, dalpha, dmu_sum, dsig_sum = v[0], v[1:L + 1], v[L + 1], v[L + 2]
            return st2, (energy, dalpha, dmu_sum, dsig_sum)

        live = interior if active is None else interior & active  # the sites a step moves
        if redblack:
            red = red_on.get(interior.device)
            if red is None:
                red = red_on[interior.device] = torch.as_tensor(red_np, device=interior.device)
            st1, s1 = one_pass(state, live & red)
            stc, s2 = one_pass(st1, live & ~red)
            sums = [s1, s2]
        else:
            stc, s = one_pass(state, live)
            sums = [s]
        w, T, it, aux = sweep_tail_torch(sums, state, step, cfg, n_interior, active)
        new, aux = stc._replace(w=w, temperature=T, it=it), SweepAux(*aux[:3])
        if loop is None:
            return new, aux
        n, stop, bufs = loop[:3]
        for dst, src in zip(state, new):
            dst.copy_(src)
        slot = n.clamp(max=bufs.shape[1] - 1).reshape(1)
        vals = torch.stack([aux.energy, aux.ptdmu, aux.ptdsigma]).reshape(3, 1).to(bufs.dtype)
        bufs.index_copy_(1, slot, torch.where(active, vals, bufs.index_select(1, slot)))
        stop |= active & ((aux.ptdmu < cfg.tor) | (new.it > cfg.its))
        n += active
        return state, aux

    sweep.carry = carry_of
    return sweep


POLL = 10  # graph replays between reads of the device's (n, stop); timed by chip_smoke.py
_WARMUP = 2  # eager sweeps on a scratch copy of the state before a capture


def _predicated_step(sweep, problem: Problem, st: GQState, loop):
    """One sweep of the device loop, in place on the state buffers ``st`` and
    ``loop = (n, stop, bufs, planes)``: the sweep count, the stop flag, the
    ``(3, cap)`` traces and the ``(9, L, M, N)`` buffer that ``st``'s lattice
    fields view (:meth:`SegmentRunner._buffers`), all on the device: while
    ``stop`` is false the sweep runs as the host loop's does, bit for bit,
    its traces go to slot ``n``, ``n`` advances and the reference's stop
    rule (``it > its || ptdmu < tor``, ``gqmap_gpu_mixture.m:75``) may set
    ``stop``; once it is set, the step leaves everything as it is. No host
    read: a CUDA graph captures it. On the K8 route kernel K9 does that
    bookkeeping (in v2, K8's last CTA), K8's new lattice comes back into
    ``planes`` in one copy (v2 with K2's gradients: written there) and, in
    v2, ``loop``'s fifth entry, the carry, holds what the next sweep
    reads in place of its torch expressions."""
    sweep(problem, st, loop=loop)


def _same(a, b) -> bool:
    """Whether two problems hold the same tensors (by identity) and the same
    other values: a captured graph reads the tensors it was captured on."""
    if isinstance(a, (torch.Tensor, np.ndarray)) or isinstance(b, (torch.Tensor, np.ndarray)):
        return a is b
    if isinstance(a, tuple) and isinstance(b, tuple):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a == b


class _Captured(NamedTuple):
    """A captured sweep and the buffers it reads and writes."""

    graph: "torch.cuda.CUDAGraph"
    problem: Problem  # the caller's, to tell whether a later call's is the same
    run: Problem  # the one the graph reads (init_flow on the device), kept as long as it
    st: GQState
    loop: tuple  # (n, stop, bufs, planes): see _predicated_step
    deltas: tuple  # each launch counter's increase in one sweep


class SegmentRunner:
    """``seg(problem, state, limit) -> (state, n_done, energy_buf, ptdmu_buf,
    ptdsigma_buf, stopped)``: see :func:`make_segment_runner`.

    After a call, ``route`` names the route it took, ``polls`` counts the
    host's reads of the sweep count and stop flag, and ``capture_s`` is the
    host seconds of the last capture (warm-up included; None before one).

    ``_route`` forces a route, for tests and for holding the graph to its
    plain version: ``"host"``, ``"graph"``, or ``"predicated"`` (the graph
    route's loop with the eager predicated sweep in place of each replay, on
    any device). None, as :func:`make_segment_runner` leaves it, chooses by
    the device and the mesh.
    """

    def __init__(self, cfg: GQMAPConfig, image_shape, mesh=None, _route: str | None = None):
        if _route not in (None, "graph", "host", "predicated"):
            raise ValueError(f"unknown segment route {_route!r}")
        if mesh is not None and _route not in (None, "host"):
            raise ValueError(f"route {_route!r} with a mesh: the sharded sweep's collectives "
                             "are host calls, so a mesh runs the host loop")
        if mesh is None:
            self.sweep = make_sweep(cfg, image_shape)
        else:
            from ..parallel.halo import make_halo_sweep

            self.sweep = make_halo_sweep(cfg, image_shape, mesh)
        self.cfg, self.mesh, self._route = cfg, mesh, _route
        self.route = None
        self.polls = 0
        self.capture_s = None
        self._captured = None

    def __call__(self, problem: Problem, state: GQState, limit: int):
        limit = int(limit)
        cap = max(self.cfg.eval_every, limit)
        route = self._route
        if route is None:
            route = "graph" if self.mesh is None and state.muu.device.type == "cuda" else "host"
        if route == "graph" and state.muu.device.type != "cuda":
            raise RuntimeError(f"the graph route needs CUDA tensors, got {state.muu.device}")
        self.route = route
        if route == "host":
            return self._host(problem, state, limit, cap)
        return self._device(problem, state, limit, cap, route == "graph")

    def _host(self, problem, state, limit, cap):
        """The host loop: one read of the stop flag a sweep."""
        bufs = torch.zeros((3, cap), dtype=_dt(self.cfg), device=state.muu.device)
        n, stop = 0, False
        while n < limit and not stop:
            state, aux = self.sweep(problem, state)
            bufs[:, n] = torch.stack([aux.energy, aux.ptdmu, aux.ptdsigma])
            n += 1
            stop = bool(((aux.ptdmu < self.cfg.tor) | (state.it > self.cfg.its)).item())
        self.polls = n
        return state, n, bufs[0], bufs[1], bufs[2], stop

    def _device(self, problem, state, limit, cap, graph: bool):
        """The device loop: ``POLL`` predicated sweeps (graph replays, or the
        eager step on the ``"predicated"`` route) between reads of ``(n,
        stop)``, and a read at the end. A stop inside a window leaves the
        window's later sweeps without effect, but a graph's replays all run
        (and launch) the whole sweep: up to ``POLL - 1`` sweeps' time is
        spent after a stop. Each counter grows by its sweep's launches a
        replay."""
        if graph:
            c = self._graph_for(problem, state, cap)
            st, loop = c.st, c.loop
            n, stop, bufs = loop[:3]
            for dst, src in zip(st, state):
                dst.copy_(src)
            n.zero_()
            stop.zero_()
            bufs.zero_()
            if len(loop) > 4:  # the carry, rebuilt from the state copied in
                self.sweep.carry(c.run, st, into=loop[4])
        else:
            st, loop = self._buffers(state, cap, problem)
            n, stop, bufs = loop[:3]
        done, polls, n_done, stopped = 0, 0, 0, 0
        while done < limit and not stopped:
            for _ in range(min(POLL, limit - done)):
                if graph:
                    c.graph.replay()
                else:
                    _predicated_step(self.sweep, problem, st, loop)
                done += 1
            n_done, stopped = torch.stack([n, stop.long()]).tolist()  # the window's one read
            polls += 1
        self.polls = polls
        if graph:
            for f, d in zip(COUNTED, c.deltas):
                f.launches += d * done
            st = GQState(*(x.clone() for x in st))
            bufs = bufs[:, :cap].clone()
        return st, n_done, bufs[0], bufs[1], bufs[2], bool(stopped)

    def _buffers(self, state, cap, problem=None):
        """The device loop's state (a copy of ``state``, its lattice fields
        views of one ``(9, L, M, N)`` buffer, as kernel K8 writes it) and its
        ``loop``: the sweep count, the stop flag, the ``(3, cap)`` traces and
        that buffer; with ``problem``, on the K8 v2 route, also the carry
        (``sweep.carry``) built from the state by its plain expressions."""
        dev = state.muu.device
        planes = torch.empty((9,) + tuple(state.muu.shape), dtype=state.muu.dtype, device=dev)
        lattice = lattice_views(planes)
        for dst, f in zip(lattice, _LATTICE):
            dst.copy_(getattr(state, f))
        st = GQState(state.w.clone(), *lattice, state.temperature.clone(), state.it.clone())
        loop = (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros((3, cap), dtype=_dt(self.cfg), device=dev), planes)
        carry_of = getattr(self.sweep, "carry", None)  # the sharded sweep has none
        carry = None if problem is None or carry_of is None else carry_of(problem, st)
        return st, loop if carry is None else loop + (carry,)

    def _graph_for(self, problem, state, cap) -> _Captured:
        """The graph for this problem, state layout and trace length, captured
        if the last one does not fit (which is released first)."""
        c = self._captured
        if (c is not None and c.loop[2].shape[1] >= cap and _same(problem, c.problem)
                and all(a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
                        for a, b in zip(state, c.st))):
            return c
        self._captured = None
        self._captured = self._capture(problem, state, cap)
        return self._captured

    def _capture(self, problem, state, cap) -> _Captured:
        """Warm up (eager predicated sweeps on a side stream, on a scratch copy
        of the state: the lazy masks, rule tables and library load happen
        here, outside the capture) and capture one predicated sweep that
        reads and writes static buffers. Launch counters are left as they
        were; the capture's increase is kept as the sweep's launches."""
        t = time.perf_counter()
        dev = state.muu.device
        run = problem
        if problem.init_flow is not None:  # a host array would be copied every sweep
            run = problem._replace(init_flow=torch.as_tensor(
                problem.init_flow, dtype=problem.I1.dtype, device=dev))
        st, loop = self._buffers(state, cap, run)
        held = [f.launches for f in COUNTED]
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(_WARMUP):
                    _predicated_step(self.sweep, run, st, loop)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                before = [f.launches for f in COUNTED]
                _predicated_step(self.sweep, run, st, loop)
                deltas = tuple(f.launches - b for f, b in zip(COUNTED, before))
        for f, h in zip(COUNTED, held):
            f.launches = h
        self.capture_s = time.perf_counter() - t
        return _Captured(graph, problem, run, st, loop, deltas)


def make_segment_runner(cfg: GQMAPConfig, image_shape, mesh=None) -> SegmentRunner:
    """Multi-sweep runner with the reference's early stop.

    ``seg(problem, state, limit)`` runs up to ``limit`` sweeps, recording the
    per-sweep Energy and mean-|dmu| / mean-|dsigma| traces on the device, and
    stops after the first sweep with ``it > its`` or ``ptdmu < tor``
    (``gqmap_gpu_mixture.m:75``). Returns ``(state, n_done, energy_buf,
    ptdmu_buf, ptdsigma_buf, stopped)``; the caller's state is not modified.

    Routes (``seg.route`` names the one a call took):

    * ``"graph"``, on a CUDA device without ``mesh``: one predicated sweep
      (:func:`_predicated_step`) captured as a ``torch.cuda.CUDAGraph`` once
      per problem, state layout and trace length, and replayed; the sweep
      count and the stop flag stay on the device, and the host reads them
      once every :data:`POLL` sweeps and at the end, as the JAX package's
      ``lax.while_loop`` evaluates its condition on the device. A capture or
      replay error raises. The graph and its memory pool go with the runner.
    * ``"host"``, on the CPU or with ``mesh``: the host loop, which reads the
      stop flag after every sweep; the plain version of the graph route.

    With ``mesh`` (a :class:`gqmap_tpu_torch.parallel.Mesh`) it runs this
    rank's shard (``parallel.halo.make_halo_sweep``) on its blocks of the
    problem and state; the stop flag comes from the summed ``ptdmu``, so
    every rank stops after the same sweep. Its collectives are host calls,
    so a mesh keeps the host loop.
    """
    return SegmentRunner(cfg, image_shape, mesh)


def make_map_fn(cfg: GQMAPConfig):
    """MAP readout: mixture mode per pixel and channel (``:53-58``)."""

    def map_fn(state: GQState) -> torch.Tensor:
        alpha = softmax(state.w) if cfg.alpha_update == "softmax_natural" else state.w
        return extract_map(alpha, state.muu, state.sigmau, state.muv, state.sigmav)

    return map_fn


def make_logp_fn(cfg: GQMAPConfig, image_shape):
    """True unnormalized log-posterior at a flow field (``:148-154``): the
    sweep's data term as a point potential (the bicubic term in place of the
    spectral series and the quadratic prior; nearest lookup, window mean and
    patch sum as configured) plus the Charbonnier edges, whatever
    ``edge_kind``, summed over the interior."""
    edge_f = make_edge_pot(cfg.lambdas, cfg.epsn)
    lp_cfg = cfg
    if cfg.data_term in ("chebyshev", "cosine", "quadratic"):
        lp_cfg = dataclasses.replace(cfg, data_term="bicubic")

    def logp(problem: Problem, flow: torch.Tensor) -> torch.Tensor:
        node_f = _node_f(lp_cfg, problem)
        interior = problem.interior
        zero = torch.zeros((), dtype=flow.dtype, device=flow.device)
        npv = node_f(flow[..., 0], flow[..., 1])
        uv = torch.movedim(flow, -1, 0)  # (chan, M, N)
        ep_v = edge_f(uv, torch.roll(uv, -1, -2))
        ep_h = edge_f(uv, torch.roll(uv, -1, -1))
        return (torch.where(interior, npv, zero).sum()
                + torch.where(interior, ep_v + ep_h, zero).sum())

    return logp


def aepe_of(cfg: GQMAPConfig, map_flow, tflow, unknown) -> float:
    """Average endpoint error with the reference's masking and cropping.

    Full resolution: unknown-GT pixels zeroed, the border ring excluded
    (``gqmap_gpu_mixture.m:63-64``). Super lattice: the MAP is repeated to
    full resolution (``repelem``) and a ``patch``-pixel border cropped
    (``gqmap_gpuSuper_mix_entropy.m:58-63``).
    """
    flow = np.array(map_flow, np.float64)
    if cfg.patch > 1:
        flow = np.repeat(np.repeat(flow, cfg.patch, 0), cfg.patch, 1)
    flow[np.asarray(unknown)] = 0.0
    t = np.asarray(tflow, np.float64)
    c = cfg.border if cfg.patch == 1 else cfg.patch
    sl = np.s_[c:-c, c:-c]
    d = t[sl] - flow[sl]
    return float(np.mean(np.sqrt((d * d).sum(-1))))


@dataclasses.dataclass
class SolveResult:
    mu: np.ndarray        # (M, N, L, 2) means, cat of (muu, muv)
    sigma: np.ndarray     # (M, N, L, 2)
    alpha: np.ndarray     # (L,)
    AEPE: np.ndarray      # (its,) NaN off the eval cadence
    Energy: np.ndarray    # (its,)
    logP: np.ndarray      # (its,) NaN off the eval cadence
    map: np.ndarray       # (M, N, 2) final extracted MAP flow
    best_aepe: float
    iters: int
    state: GQState


def solve(cfg: GQMAPConfig, I1, I2, gt_flow=None, flow_range: FlowRange | None = None,
          seed=None, out_dir=None, verbose: bool = False, callback=None,
          init: GQState | None = None, init_flow=None, checkpoint_path=None,
          checkpoint_every: int = 0, resume: bool = False, mesh=None,
          reset_at: int | None = None, device=None) -> SolveResult:
    """Run the full GQMAP inference loop.

    ``gt_flow`` (raw .flo contents) gives the clamp ranges, the unknown mask
    and the AEPE as the reference's ``optical_flow.m:12-13`` does; pass
    ``flow_range`` to run without ground truth (or to override a degenerate
    GT box). ``device`` defaults to the GPU; with no GPU it must be given.

    Checkpointing: with ``checkpoint_path`` set, the state and the run's
    traces are written every ``checkpoint_every`` sweeps (0 = only at the
    end); with ``resume=True`` an existing checkpoint restarts the run where
    it stopped and returns what an unbroken run would. ``init_flow`` (an
    (M, N, 2) array) seeds the means of every component, clamped to the
    flow range, over the random sigma init (``legacy/gqmap_gpuV2.m:13-14``);
    as in the JAX package it does not set ``Problem.init_flow``, so
    ``data_term="quadratic"`` (``legacy_v1``) runs through
    ``make_problem(...)._replace(init_flow=...)`` and the segment runner.
    ``reset_at`` applies the reference's ``reset_para`` hook after that many
    sweeps: sigma re-widened to half the flow range, correlations zeroed,
    the iteration counter restarted, means kept (``legacy/gqmap_gpuV2.m:51-62``).
    ``out_dir`` receives the MAP's Middlebury colour coding as ``<it>.png``
    at every readout (:func:`_write_viz`; needs ``imageio``).

    With ``mesh`` (a :class:`gqmap_tpu_torch.parallel.Mesh`; every rank of
    the job calls ``solve`` with the same arguments) each rank builds the
    whole problem and state, keeps its block of the lattice and runs the
    sweeps on it (``parallel.halo``). Each readout gathers the state, so
    the traces, the MAP and the ``SolveResult`` (whose state is the whole
    one) are the same on every rank; checkpoints are gathered and written by
    rank 0, and a resume slices each rank's block from the file. ``verbose``
    prints and ``out_dir`` is written on rank 0 only; ``callback`` runs on
    every rank, with the whole state. With no process group it raises.
    """
    lead = True  # the rank that prints and writes
    if mesh is not None:
        mesh.xy_group()  # raises with no process group; formed by every rank together
        lead = mesh.rank == 0

    tflow = unknown = None
    if gt_flow is not None:
        fc = flow_to_color(np.asarray(gt_flow))
        tflow, unknown = fc.flo, fc.unknown
        if flow_range is None:
            flow_range = FlowRange(fc.minu, fc.maxu, fc.minv, fc.maxv)
    if flow_range is None:
        raise ValueError("need gt_flow or flow_range")

    problem = make_problem(cfg, I1, I2, flow_range, device)
    dev = problem.I1.device
    resumed_extras = {}
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        from ..utils.checkpoint import load_checkpoint

        state, _, resumed_extras = load_checkpoint(checkpoint_path, expect_cfg=cfg, device=dev)
    elif init is not None:
        state = init
    else:
        state = init_state(cfg, flow_range, np.shape(I1), seed, dev)
        if init_flow is not None:
            fl = torch.as_tensor(np.asarray(init_flow), dtype=_dt(cfg), device=dev)
            if tuple(fl.shape[:2]) != tuple(state.muu.shape[1:]):
                raise ValueError(f"init_flow shape {tuple(fl.shape)} does not match the flow "
                                 f"lattice {tuple(state.muu.shape[1:])}")
            state = state._replace(
                muu=fl[..., 0].clamp(flow_range.minu, flow_range.maxu).expand_as(state.muu)
                .contiguous(),
                muv=fl[..., 1].clamp(flow_range.minv, flow_range.maxv).expand_as(state.muv)
                .contiguous())
    readout = problem  # the whole frames and interior, for logP
    whole = _identity
    if mesh is not None:
        from ..parallel.halo import psum
        from ..parallel.sharded import gather_state, shard_problem, shard_state

        readout = problem._replace(cheb=None)
        problem, state = shard_problem(problem, mesh), shard_state(state, mesh)

        def whole(st):
            return gather_state(st, mesh)
    seg = make_segment_runner(cfg, np.shape(I1), mesh)
    map_fn = make_map_fn(cfg)
    logp_fn = make_logp_fn(cfg, np.shape(I1))

    its = cfg.its
    Energy = np.full(its, np.nan)
    AEPE = np.full(its, np.nan)
    logP = np.full(its, np.nan)
    dmu_trace = np.full(its, np.nan)
    best_aepe = math.inf
    it_done = int(state.it) - 1  # > 0 when resuming from a checkpoint
    last_map = None

    # resume restores best_aepe and the traces, so a resumed run returns the
    # SolveResult of an unbroken one
    if "best_aepe" in resumed_extras:
        best_aepe = float(resumed_extras["best_aepe"])
    for name, arr in (("AEPE", AEPE), ("Energy", Energy), ("logP", logP), ("dmu", dmu_trace)):
        if name in resumed_extras:
            saved = np.asarray(resumed_extras[name])
            n = min(saved.size, its)
            arr[:n] = saved[:n]
    last_saved = it_done

    def save(force=False):
        nonlocal last_saved
        if checkpoint_path is None:
            return
        if force or (checkpoint_every and it_done - last_saved >= checkpoint_every):
            from ..utils.checkpoint import save_checkpoint

            st = whole(state)
            if lead:
                save_checkpoint(checkpoint_path, st, cfg, best_aepe=best_aepe, AEPE=AEPE,
                                Energy=Energy, logP=logP, dmu=dmu_trace)
            if mesh is not None:  # the file is whole on every rank's return
                torch.distributed.barrier()
            last_saved = it_done

    pending_reset = reset_at if reset_at else None

    while it_done < its:
        next_eval = 1 if it_done == 0 else (it_done // cfg.eval_every + 1) * cfg.eval_every
        next_eval = min(next_eval, its)
        if pending_reset is not None:
            next_eval = min(next_eval, pending_reset)
        limit = next_eval - it_done
        state, n, eb, pb, _, stopped = seg(problem, state, limit)
        Energy[it_done:it_done + n] = eb[:n].cpu().numpy()
        dmu_trace[it_done:it_done + n] = pb[:n].cpu().numpy()
        it_done += n
        if cfg.debug_finite:
            for f in state._fields:
                bad = (~torch.isfinite(getattr(state, f))).sum()
                if mesh is not None:  # every rank raises, or none
                    bad = psum(bad.reshape(1), mesh.xy_group())[0]
                bad = int(bad)
                if bad:
                    raise FloatingPointError(
                        f"non-finite state leaf {f!r} after sweep {it_done} ({bad} bad "
                        "values; likely the 1/(1-p^2) blow-up near the correlation clamp)")

        if n == limit:  # reached the eval iteration
            st = whole(state)
            map_t = map_fn(st)
            last_map = map_t.cpu().numpy()
            lp = float(logp_fn(readout, map_t))
            logP[it_done - 1] = lp
            if tflow is not None:
                aepe = aepe_of(cfg, last_map, tflow, unknown)
                AEPE[it_done - 1] = aepe
                best_aepe = min(best_aepe, aepe)
            if out_dir is not None and lead:
                _write_viz(cfg, last_map, out_dir, it_done)
            if verbose and lead:
                print(f"[{it_done}] dmu={dmu_trace[it_done - 1]:.3e} "
                      f"E={Energy[it_done - 1]:.6e} AEPE={best_aepe:.4f} logP={lp:.6e}")
            if callback is not None:
                callback(it_done, st, last_map, AEPE[it_done - 1], lp)
        if pending_reset is not None and it_done >= pending_reset:
            # reset_para: re-widen sigma, zero the correlations, restart the
            # schedule; keep mu and best_aepe
            state = state._replace(
                sigmau=torch.full_like(state.sigmau, (flow_range.maxu - flow_range.minu) / 2.0),
                sigmav=torch.full_like(state.sigmav, (flow_range.maxv - flow_range.minv) / 2.0),
                pn=torch.zeros_like(state.pn),
                rou=torch.zeros_like(state.rou),
                it=torch.ones_like(state.it),
            )
            it_done = 0
            last_saved = 0
            pending_reset = None
            if verbose and lead:
                print("[reset_para] sigma, pn and rou have been reset")
            continue
        save()
        if stopped or it_done >= its:
            break

    save(force=True)
    state = whole(state)
    if last_map is None:
        last_map = map_fn(state).cpu().numpy()
    alpha = softmax(state.w) if cfg.alpha_update == "softmax_natural" else state.w

    def api(u, v):
        return np.stack([np.moveaxis(u.cpu().numpy(), 0, -1),
                         np.moveaxis(v.cpu().numpy(), 0, -1)], axis=-1)

    return SolveResult(
        mu=api(state.muu, state.muv),
        sigma=api(state.sigmau, state.sigmav),
        alpha=alpha.cpu().numpy(),
        AEPE=AEPE,
        Energy=Energy,
        logP=logP,
        map=last_map,
        best_aepe=best_aepe,
        iters=it_done,
        state=state,
    )


def _identity(x):
    return x


def _write_viz(cfg: GQMAPConfig, map_flow, out_dir, it):
    """Write the MAP's colour coding as ``<out_dir>/<it>.png``; on the super
    lattice the MAP is repeated to full resolution and a ``patch``-pixel
    border cropped. ``imageio`` is imported here, so only a run with
    ``out_dir`` needs it."""
    import imageio.v2 as imageio

    os.makedirs(out_dir, exist_ok=True)
    flow = np.asarray(map_flow, np.float64)
    if cfg.patch > 1:
        p = cfg.patch
        flow = np.repeat(np.repeat(flow, p, 0), p, 1)[p:-p, p:-p]
    imageio.imwrite(os.path.join(out_dir, f"{it}.png"), flow_to_color(flow).img)
