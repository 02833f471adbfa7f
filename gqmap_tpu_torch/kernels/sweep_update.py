"""Kernels K8 and K9: the sweep's update around the node and edge kernels, on the card.

The JAX package runs no Pallas kernel here: its sweep is one jit-compiled
program (``gqmap_tpu/models/gqmap.py:276``), in which XLA fuses the finalize
of each term's raw sums, the neighbour assembly, the clamped step, the four
reductions and the alpha update, anneal and counter (``:386-616``). The
CUDA kernels are ``gqmap_tpu_torch/csrc/sweep_update.cu``; their plain
versions are that glue as the port ran it, operation for operation:

* K8, :func:`site_update_cuda` (one launch a pass): from the node route's
  raw output (:class:`NodeSums`: K1's six cosine mode sums, a ``GQRaw`` or
  K7's ``GQChainRaw``) and the edge route's (:class:`EdgeSums`: K2's
  finalized gradients or a ``GQRaw``), every site's finalized gradients,
  their neighbour assembly and the clamped step over the pass's mask; the
  new state as one ``(9, L, M, N)`` buffer (:func:`lattice_views`) and one
  partial a CTA of the energy, dalpha, sum |dmuu| and sum |dsigmau|, ``(L,
  G, 4)``. Its plain version is :func:`site_update_torch`.
* K9, :func:`sweep_tail_cuda` (one launch a sweep): the partials summed in a
  fixed order, the alpha step, the anneal, the counter, the predicate,
  ``SweepAux`` and dalpha; in the segment runner's device loop (``loop``) also the
  trace slot, the stop flag and the sweep count, with w, T and it updated in
  place. Its plain version is :func:`sweep_tail_torch`.

``site_update_cuda.launches`` and ``sweep_tail_cuda.launches`` count their
launches. Both raise for tensors that are not on a CUDA device; the sweep
(``models/gqmap._update_route``) runs the plain versions on the CPU, for
``node_kernel="torch"``, the autodiff estimator and a mesh.

On the card the new state is the plain version's bit for bit, given the
same kernel outputs, alpha, step and T; the four sums differ from
``torch.sum`` only in their order (a CTA's halving tree, then K9's strided
running sums and halving tree), and K9's alpha step and SweepAux with them.

Two variants (``site_update_cuda(..., variant=...)``):

* ``"v1"``: one thread a site over rows of 256 sites; a raw edge is
  finalized by its owner and its endpoint-2 terms again by the neighbour
  they come back to; K9 is a launch of its own.
* ``"v2"``, the default: 2-D tiles of :data:`TILE` sites of one component
  staged into shared memory by asynchronous copies, double-buffered in a
  persistent loop; each raw edge finalized once (its endpoint-2 terms go
  to the neighbour through shared memory; the halo's edges above and left
  of a tile are evaluated for those terms alone); one partial a tile; and
  with ``tail`` (:class:`Tail`) K9's work in the last CTA to finish
  (:data:`sweep_tail_v2` counts it), so a sweep launches K8 once a pass and
  nothing else. With ``carry`` (:class:`Carry`, the device loop's) it also
  writes what the next sweep would compute in torch: the step and alpha
  (the tail), K1's phase and scale stack (:func:`cosine_gq.phase_stack`)
  and the raw edges' neighbour stacks; with ``out`` (the grads edge form)
  the new lattice goes straight into the state's buffer. The new state is
  v1's bit for bit; the sums differ from v1's in their order (a tile's
  warps, then 256 strided running sums and a halving tree).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cosine import CosData, _finalize_mode_sums
from ..ops.gq import (_CONST1, _SQRT2, EDGE, NODE, GQChainRaw, GQGrads, GQRaw, finalize,
                      finalize_chain)
from ..ops.simplex import project_simplex, softmax_natural_step
from . import build
from .edge_reduced_gq import neighbour_stacks

__all__ = ["NODE_FORMS", "EDGE_FORMS", "VARIANTS", "NodeSums", "EdgeSums", "Tail", "Carry",
           "CTA_SITES", "TAIL_THREADS", "TILE", "MAX_CARRY_L", "W_CLIP", "lattice_views",
           "stack2", "site_update_cuda", "site_update_torch", "step_torch", "sweep_tail_cuda",
           "sweep_tail_torch", "sweep_tail_v2", "site_consts", "partial_blocks", "tile_blocks",
           "step_of", "step_as_card", "card_sum", "softmax_as_card", "v2_tail_sums"]

NODE_FORMS = ("modes", "raw", "chain")  # K8's node instances, codes 0, 1, 2
EDGE_FORMS = ("grads", "raw")           # K8's edge instances, codes 0, 1
VARIANTS = ("v1", "v2")                 # K8's; "v2" by default
CTA_SITES = 256     # K8 v1: sites a CTA, each CTA one partial
TAIL_THREADS = 512  # K9's one CTA
TILE = (8, 32)      # K8 v2: a tile's rows and columns (a warp a row), each tile one partial
V2_THREADS = 256    # K8 v2's CTA, and its last CTA's strided sums
MAX_CARRY_L = 64    # the tail writes alpha's carry up to this L (card_sum's model)
W_CLIP = 300.0      # softmax_natural_step's clip of the logits
_FIELDS = {"modes": 6, "raw": 6, "chain": 7}
_STATE = ("muu", "muv", "sigmau", "sigmav", "pn")


class NodeSums(NamedTuple):
    """The node route's raw output: ``form`` ``"modes"`` (K1's six mode sums
    ``(E0, A1, A2, Aa, Ab, Ax)`` on the coefficient field ``cos``),
    ``"raw"`` (a ``GQRaw``) or ``"chain"`` (a ``GQChainRaw``); ``fields``
    of ``(L, M, N)`` each."""

    form: str
    fields: tuple
    cos: CosData | None = None


class EdgeSums(NamedTuple):
    """The edge route's output: ``form`` ``"grads"`` (K2's finalized ``(da,
    du1, du2, do1, do2, dp)``) or ``"raw"`` (a ``GQRaw``, finalized with the
    edge's entropy sign); ``fields`` of ``(2, 2, L, M, N)`` each. ``o2e``,
    endpoint 2's sigma stack where the route built it (the plain version
    builds it otherwise; the kernel reads the neighbours' sigma itself)."""

    form: str
    fields: tuple
    o2e: torch.Tensor | None = None


class Tail(NamedTuple):
    """K9's work for K8 v2's last CTA, on the sweep's last pass: ``state`` the
    sweep's starting state (its w, T and it), ``n_interior``, ``prev`` the
    partials of red-black's first pass (None in Jacobi) and ``loop`` the device
    loop's ``(n, stop, bufs)`` (None: the new w, T and it are new tensors)."""

    state: tuple
    n_interior: int
    prev: torch.Tensor | None = None
    loop: tuple | None = None


class Carry(NamedTuple):
    """What K8 v2 writes for the next sweep on the device loop, in static
    buffers: ``step`` (``()``) and ``alpha`` (``(L,)``; None where the sweep
    takes softmax in torch or w itself) from the tail, ``stack`` K1's
    ``(5, L, M, N)`` phases and scales (None off the cosine term), ``u2e`` and
    ``o2e`` the raw edges' ``(2, 2, L, M, N)`` neighbour stacks (None for K2's
    gradients). Each is what the plain expression gives on the new state."""

    step: torch.Tensor
    alpha: torch.Tensor | None = None
    stack: torch.Tensor | None = None
    u2e: torch.Tensor | None = None
    o2e: torch.Tensor | None = None


def lattice_views(planes: torch.Tensor):
    """``(muu, muv, sigmau, sigmav, pn, rou)`` as views of a ``(9, L, M, N)``
    buffer, ``rou`` its last four planes as ``(2, 2, L, M, N)``."""
    return (*planes[:5].unbind(0), planes[5:].unflatten(0, (2, 2)))


def stack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.stack([a, b])``, as a view where ``b`` is the plane right after
    ``a`` in one buffer (the state :func:`site_update_cuda` writes), which
    launches nothing."""
    n = a.numel() * a.element_size()
    if (a.is_contiguous() and b.is_contiguous() and a.shape == b.shape and a.dtype == b.dtype
            and a.device == b.device and b.data_ptr() == a.data_ptr() + n
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()):
        return torch.as_strided(a, (2,) + tuple(a.shape), (a.numel(),) + a.stride())
    return torch.stack([a, b])


# ---- the plain versions: the glue, operation for operation ----------------------------

def node_grads_torch(node: NodeSums, a3, state, T) -> GQGrads:
    """The node term's finalized gradients from its route's raw output."""
    site = (state.sigmau, state.sigmav, state.pn)
    if node.form == "modes":
        return _finalize_mode_sums(node.cos, node.fields, state.muu, *site, a3, T, NODE)
    if node.form == "chain":
        return finalize_chain(GQChainRaw(*node.fields), a3, *site, T, NODE)
    return finalize(GQRaw(*node.fields), a3, *site, T, NODE)


def edge_grads_torch(edge: EdgeSums, a3, mu, sg, rou, T, roll=torch.roll) -> GQGrads:
    """The edge term's finalized gradients: K2's as they are (with ``E``), raw
    sums finalized against endpoint 2's sigma."""
    if edge.form == "grads":
        da, du1, du2, do1, do2, dp = edge.fields
        return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp, E=a3 * da)
    o2e = edge.o2e if edge.o2e is not None else neighbour_stacks(mu, sg, roll)[1]
    return finalize(GQRaw(*edge.fields), a3, sg[None], o2e, rou, T, EDGE)


def step_torch(state, grads, step, mask, cfg, rng):
    """The clamped ascent over ``mask`` (``gqmap_gpu_mixture.m:41-46``) with
    ``grads = (dmuu, dmuv, dsigmau, dsigmav, dpn, drou)``: the state with its
    new lattice fields, and sum |dmuu| and sum |dsigmau| over the mask."""
    dmuu, dmuv, dsigmau, dsigmav, dpn, drou = grads
    zero = torch.zeros((), dtype=dmuu.dtype, device=dmuu.device)
    sstep = step * cfg.sigma_step_scale

    def upd(x, dx, lo, hi, s=step):
        return torch.where(mask, torch.clamp(x + dx * s, lo, hi), x)

    new = state._replace(
        muu=upd(state.muu, dmuu, rng.minu, rng.maxu),
        muv=upd(state.muv, dmuv, rng.minv, rng.maxv),
        sigmau=upd(state.sigmau, dsigmau, cfg.sigma_min, cfg.sigma_max, sstep),
        sigmav=upd(state.sigmav, dsigmav, cfg.sigma_min, cfg.sigma_max, sstep),
        rou=upd(state.rou, drou, -cfg.corr_tor, cfg.corr_tor),
        pn=upd(state.pn, dpn, -cfg.corr_tor, cfg.corr_tor))
    dmu_sum = torch.where(mask, dmuu.abs(), zero).sum()
    dsig_sum = torch.where(mask, dsigmau.abs(), zero).sum()
    return new, dmu_sum, dsig_sum


def site_update_torch(node: NodeSums, edge: EdgeSums, state, alpha, T, step, interior, mask,
                      cfg, rng, roll=torch.roll):
    """Plain version of K8 over the site mask ``mask``: the finalize of both
    terms, the neighbour assembly (endpoint-1 terms stay, endpoint-2 terms go
    back to the neighbour that owns them, ``gqmap_gpu_mixture.m:37-40``; one
    roll an axis for the four), the energy and dalpha over the interior
    (``:36, :48``) and the clamped step. Returns the state with its new
    lattice fields and ``(energy, dalpha, dmu_sum, dsig_sum)``. ``roll`` is
    the lattice's roll (on a shard, the global one)."""
    L = alpha.shape[0]
    a3 = alpha.reshape(L, 1, 1)
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    gn = node_grads_torch(node, a3, state, T)
    mu = stack2(state.muu, state.muv)
    sg = stack2(state.sigmau, state.sigmav)
    ge = edge_grads_torch(edge, a3, mu, sg, state.rou, T, roll)

    d2 = torch.stack([ge.du2, ge.do2])  # (mu | sigma, dir, C, L, M, N)
    up, left = roll(d2[:, 0], 1, -2), roll(d2[:, 1], 1, -1)

    def assemble(dn, d1, k, chan):
        return dn + d1[0, chan] + d1[1, chan] + up[k, chan] + left[k, chan]

    dmuu = assemble(gn.du1, ge.du1, 0, 0)
    dmuv = assemble(gn.du2, ge.du1, 0, 1)
    dsigmau = assemble(gn.do1, ge.do1, 1, 0)
    dsigmav = assemble(gn.do2, ge.do1, 1, 1)

    energy = (torch.where(interior, gn.E, zero).sum()
              + torch.where(interior, ge.E, zero).sum())
    dalpha = (torch.where(interior, gn.da, zero).sum((-2, -1))
              + torch.where(interior, ge.da, zero).sum((0, 1, -2, -1)))
    new, dmu_sum, dsig_sum = step_torch(state, (dmuu, dmuv, dsigmau, dsigmav, gn.dp, ge.dp),
                                        step, mask, cfg, rng)
    return new, (energy, dalpha, dmu_sum, dsig_sum)


def sweep_tail_torch(sums, state, step, cfg, n_interior: int, active=None):
    """Plain version of K9: ``sums`` holds each pass's ``(energy, dalpha,
    dmu_sum, dsig_sum)`` (two in red-black: the energy and dalpha are the
    second's, |dmu| and |dsigma| both passes'); the mixture-weight update
    after ``alpha_start`` (``:50``), the anneal (``:69-73``), the counter and
    the predicate ``active``. Returns ``(w, T, it, (energy, ptdmu, ptdsigma,
    dalpha))``, the first three the ``SweepAux`` fields."""
    energy, dalpha = sums[-1][0], sums[-1][1]
    dmu_sum, dsig_sum = sums[0][2], sums[0][3]
    if len(sums) == 2:
        dmu_sum, dsig_sum = dmu_sum + sums[1][2], dsig_sum + sums[1][3]
    w = state.w
    T = state.temperature
    if cfg.L > 1:
        lr = step * cfg.alpha_lr_scale
        if cfg.alpha_update == "softmax_natural":
            w_new = softmax_natural_step(state.w, dalpha, lr)
        else:
            w_new = project_simplex(state.w + dalpha * lr)
        w = torch.where(state.it > cfg.alpha_start, w_new, state.w)
    if cfg.anneal_every > 0:
        T = torch.where(state.it % cfg.anneal_every == 0,
                        torch.clamp(T * cfg.drate, min=cfg.t_floor), T)
    it = state.it + 1
    if active is not None:
        w, T, it = (torch.where(active, x, x0) for x, x0 in
                    ((w, state.w), (T, state.temperature), (it, state.it)))
    return w, T, it, (energy, dmu_sum / n_interior, dsig_sum / n_interior, dalpha)


def step_of(it, cfg, dtype):
    """The sweep's step from the iteration counter ``it`` (a tensor of no
    dimensions), as the plain glue computes it: ``step0 / (1 + it /
    step_tau)``, or ``step0`` for a constant step."""
    if cfg.step_const:
        return torch.full((), cfg.step0, dtype=dtype, device=it.device)
    return cfg.step0 / (1.0 + it.to(dtype) / cfg.step_tau)


def _inv_tau(cfg, dtype) -> float:
    """``1 / step_tau`` rounded to ``dtype``, as PyTorch's CUDA division of a
    tensor by a Python scalar takes it (a product by the reciprocal)."""
    if cfg.step_const:
        return 0.0
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(cfg.step_tau))
    return 1.0 / cfg.step_tau


def step_as_card(it, cfg, dtype):
    """:func:`step_of` as the card rounds it, which K9 v2's carry follows:
    ``it / step_tau`` a product by the reciprocal (:func:`_inv_tau`)."""
    if cfg.step_const:
        return torch.full((), cfg.step0, dtype=dtype, device=it.device)
    return cfg.step0 / (1.0 + it.to(dtype) * _inv_tau(cfg, dtype))


def card_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D tensor of at most :data:`MAX_CARRY_L` values in the
    order of PyTorch's CUDA reduction (``csrc/sweep_update.cu`` torch_sum): the
    length rounded down to a power of two, ``bw``, threads, thread j adding
    ``x[j]`` and ``x[j + bw]``, then a halving tree over the ``bw`` threads
    (shared memory down to a warp, then shuffles with decreasing offsets)."""
    n = x.shape[0]
    if not 1 <= n <= MAX_CARRY_L:
        raise ValueError(f"card_sum takes 1 to {MAX_CARRY_L} values, got {n}")
    bw = 1 << (n.bit_length() - 1)
    acc = [x[j] + x[j + bw] if j + bw < n else x[j] for j in range(bw)]
    while len(acc) > 1:
        h = len(acc) // 2
        acc = [acc[j] + acc[j + h] for j in range(h)]
    return acc[0]


def softmax_as_card(w: torch.Tensor) -> torch.Tensor:
    """``softmax(w)`` (``exp(w) / exp(w).sum()``) with the sum in the card's
    order (:func:`card_sum`), which K9 v2's carry follows."""
    e = torch.exp(w)
    return e / card_sum(e)


def _strided(x: torch.Tensor) -> torch.Tensor:
    """K8 v2's last CTA's sum of ``x``: :data:`V2_THREADS` threads' running
    sums from 0 over a stride of :data:`V2_THREADS`, then a halving tree."""
    x = x.reshape(-1)
    n = -(-x.numel() // V2_THREADS) * V2_THREADS
    pad = torch.zeros(n, dtype=x.dtype, device=x.device)
    pad[:x.numel()] = x
    acc = torch.zeros(V2_THREADS, dtype=x.dtype, device=x.device)
    for row in pad.reshape(-1, V2_THREADS):
        acc = acc + row
    while acc.numel() > 1:
        acc = acc[:acc.numel() // 2] + acc[acc.numel() // 2:]
    return acc[0]


def v2_tail_sums(part: torch.Tensor, prev: torch.Tensor | None = None):
    """The sums K8 v2's last CTA takes of its ``(L, G, 4)`` partials (and of
    red-black's first pass's ``prev``), in its order: ``(energy, dalpha,
    dmu_sum, dsig_sum)``, every sum one strided pass over the partials,
    dalpha[l] adding only component l's (a zero elsewhere leaves a sum as it
    is); red-black's |dmu| and |dsigma| the first pass's plus the second's."""
    L, G, _ = part.shape
    comp = torch.arange(L * G, device=part.device) // G
    da = part[..., 1].reshape(-1)
    zero = torch.zeros((), dtype=part.dtype, device=part.device)
    dalpha = torch.stack([_strided(torch.where(comp == q, da, zero)) for q in range(L)])
    dmu, dsig = _strided(part[..., 2]), _strided(part[..., 3])
    if prev is not None:
        dmu, dsig = _strided(prev[..., 2]) + dmu, _strided(prev[..., 3]) + dsig
    return _strided(part[..., 0]), dalpha, dmu, dsig


# ---- the kernels ------------------------------------------------------------------------

def site_consts(node: NodeSums, cfg, rng) -> tuple:
    """K8's constants in ``Consts``' order (``csrc/sweep_update.cu``), folded
    as the plain version folds them in Python."""
    ku = kv = 0.0
    if node.form == "modes":
        ku = math.pi / (node.cos.hi_u - node.cos.lo_u)
        kv = math.pi / (node.cos.hi_v - node.cos.lo_v)
    return (ku, kv, -0.5 * ku, 0.5 * ku, 0.5 * kv, 1.0 / math.pi, _SQRT2, _CONST1, NODE, EDGE,
            rng.minu, rng.maxu, rng.minv, rng.maxv, cfg.sigma_min, cfg.sigma_max,
            -cfg.corr_tor, cfg.corr_tor, cfg.sigma_step_scale)


def partial_blocks(M: int, N: int) -> int:
    """K8 v1's CTAs a component, ``G``: its partials are ``(L, G, 4)``."""
    return -(-M * N // CTA_SITES)


def tile_blocks(M: int, N: int) -> int:
    """K8 v2's tiles a component, ``G``: its partials are ``(L, G, 4)``, tile
    ``(i, j)`` (rows ``TILE[0] i``.., columns ``TILE[1] j``..) at ``i *
    ceil(N / TILE[1]) + j``."""
    return -(-M // TILE[0]) * -(-N // TILE[1])


def _check(name, x, shape, dtype, device):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be {dtype} on {device}, got {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _predicate(name, x, device):
    if x is not None:
        _check(name, x, (), torch.bool, device)
        return x.data_ptr()
    return None


def site_update_cuda(node: NodeSums, edge: EdgeSums, state, alpha, T, step, interior, cfg,
                     rng, colour: int | None = None, active=None, stop=None,
                     variant: str | None = None, tail: Tail | None = None,
                     carry: Carry | None = None, out=None, max_ctas: int = 0):
    """Kernel K8: one pass over the sites ``interior & active & ~stop`` of
    colour ``colour`` (None: every site; 0: red, ``(m + n)`` even; 1: black).
    Returns the new ``(9, L, M, N)`` state buffer (:func:`lattice_views`) and
    the ``(L, G, 4)`` partials (energy, dalpha, sum |dmuu|, sum |dsigmau| of
    each CTA, v1, or tile, v2). ``alpha`` (``(L,)``), ``T`` and ``step``
    (``()``) are tensors on the card: the kernel reads them through pointers.

    ``variant`` (None: ``"v2"``). Only v2 takes ``tail`` (it then also
    returns ``(w, T, it, (energy, ptdmu, ptdsigma, dalpha))`` as
    :func:`sweep_tail_cuda` does, the tail run by its last CTA; with
    ``tail.loop`` w, T and it are updated in place and the loop's
    bookkeeping done), ``carry`` (the step and alpha need ``tail``) and
    ``out``, the state's own ``(9, L, M, N)`` buffer to write in place, for
    K2's gradients only (the raw forms read the neighbours' sigma and rho).
    ``max_ctas`` caps v2's grid (0: as many CTAs as fit on the card)."""
    variant = "v2" if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown K8 variant {variant!r}")
    if variant == "v1" and (tail is not None or carry is not None or out is not None):
        raise ValueError("K8 v1 takes no tail, carry or out (K9 v1 is a launch of its own)")
    muu = state.muu
    if muu.device.type != "cuda":
        raise RuntimeError(f"site_update_cuda needs CUDA tensors, got {muu.device}")
    if muu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"site_update_cuda takes float32 or float64, not {muu.dtype}")
    if muu.ndim != 3:
        raise ValueError(f"muu must be (L, M, N), got {tuple(muu.shape)}")
    if node.form not in NODE_FORMS or edge.form not in EDGE_FORMS:
        raise ValueError(f"unknown node form {node.form!r} or edge form {edge.form!r}")
    if colour not in (None, 0, 1):
        raise ValueError(f"colour must be None, 0 or 1, got {colour!r}")
    L, M, N = muu.shape
    dt, dev = muu.dtype, muu.device
    site, edge_shape = (L, M, N), (2, 2, L, M, N)
    for f in _STATE:
        _check(f, getattr(state, f), site, dt, dev)
    _check("rou", state.rou, edge_shape, dt, dev)
    for name, x, shape in (("alpha", alpha, (L,)), ("T", T, ()), ("step", step, ())):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor on the card")
        _check(name, x, shape, dt, dev)
    _check("interior", interior, (M, N), torch.bool, dev)
    if len(node.fields) != _FIELDS[node.form] or len(edge.fields) != 6:
        raise ValueError(f"{node.form!r} takes {_FIELDS[node.form]} node fields and "
                         f"{edge.form!r} 6 edge fields, got {len(node.fields)} and "
                         f"{len(edge.fields)}")
    for k, x in enumerate(node.fields):
        _check(f"node field {k}", x, site, dt, dev)
    for k, x in enumerate(edge.fields):
        _check(f"edge field {k}", x, edge_shape, dt, dev)
    nodes = [x.data_ptr() for x in node.fields] + [None] * (7 - len(node.fields))
    consts = site_consts(node, cfg, rng)
    if variant == "v1":
        G = partial_blocks(M, N)
        planes = torch.empty((9, L, M, N), dtype=dt, device=dev)
        part = torch.empty((L, G, 4), dtype=dt, device=dev)
        ptrs = (ctypes.c_void_p * 27)(
            *(getattr(state, f).data_ptr() for f in _STATE), state.rou.data_ptr(),
            planes.data_ptr(), alpha.data_ptr(), T.data_ptr(), step.data_ptr(),
            interior.data_ptr(), _predicate("active", active, dev),
            _predicate("stop", stop, dev), *nodes, *(x.data_ptr() for x in edge.fields),
            part.data_ptr())
        dconsts = (ctypes.c_double * 19)(*consts)  # held until the call returns
        lib = build.library_for(dev)
        fn = lib.gqmap_site_update_f32 if dt == torch.float32 else lib.gqmap_site_update_f64
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(fn(ctypes.addressof(ptrs), ctypes.addressof(dconsts),
                       NODE_FORMS.index(node.form), EDGE_FORMS.index(edge.form), L, M, N,
                       -1 if colour is None else colour, dev.index, stream),
                    "site_update_cuda")
        site_update_cuda.launches += 1
        return planes, part

    if out is not None:
        if edge.form != "grads":
            raise ValueError("K8 v2 writes in place only for K2's gradients: the raw edge "
                             "forms read the neighbours' sigma and rho")
        _check("out", out, (9, L, M, N), dt, dev)
        if any(x.data_ptr() != y.data_ptr() for x, y in
               zip(lattice_views(out), (*(getattr(state, f) for f in _STATE), state.rou))):
            raise ValueError("out must be the buffer whose lattice_views are the state's")
    planes = torch.empty((9, L, M, N), dtype=dt, device=dev) if out is None else out
    G = tile_blocks(M, N)
    part = torch.empty((L, G, 4), dtype=dt, device=dev)
    softmax_mode = int(cfg.alpha_update == "softmax_natural")
    tptr = [None] * 11  # part_prev, ticket, w, it, w_out, T_out, it_out, aux, n, stop_out, bufs
    cap, res = 1, None
    if tail is not None:
        st0 = tail.state
        _check("w", st0.w, (L,), dt, dev)
        _check("T", st0.temperature, (), dt, dev)
        _check("it", st0.it, (), torch.int32, dev)
        if tail.prev is not None:
            _check("prev", tail.prev, (L, G, 4), dt, dev)
        if tail.loop is not None:
            if active is not None:
                raise ValueError("the device loop's predicate is its stop flag: pass no active")
            n, lstop, bufs = tail.loop
            _check("n", n, (), torch.int64, dev)
            _check("stop", lstop, (), torch.bool, dev)
            if stop is None or stop.data_ptr() != lstop.data_ptr():
                raise ValueError("the device loop's stop flag is K8's stop")
            if bufs.ndim != 2 or bufs.shape[0] != 3:
                raise ValueError(f"bufs must be (3, cap), got {tuple(bufs.shape)}")
            cap = bufs.shape[1]
            _check("bufs", bufs, (3, cap), dt, dev)
            outs = (st0.w, st0.temperature, st0.it)
            loop_ptrs = (n.data_ptr(), lstop.data_ptr(), bufs.data_ptr())
        else:
            outs = (torch.empty_like(st0.w), torch.empty_like(st0.temperature),
                    torch.empty_like(st0.it))
            loop_ptrs = (None, None, None)
        aux = torch.empty(3 + 2 * L, dtype=dt, device=dev)  # SweepAux, dalpha, scratch
        tptr = [None if tail.prev is None else tail.prev.data_ptr(), _ticket(dev).data_ptr(),
                st0.w.data_ptr(), st0.it.data_ptr(), *(x.data_ptr() for x in outs),
                aux.data_ptr(), *loop_ptrs]
        res = (*outs, (*aux[:3].unbind(0), aux[3:3 + L]))
    cptr = [None] * 5  # stack, u2e, o2e, step_next, alpha_next
    if carry is not None:
        if carry.stack is not None:
            if node.form != "modes":
                raise ValueError("K1's phase stack is carried only for the cosine mode sums")
            _check("stack", carry.stack, (5, L, M, N), dt, dev)
            cptr[0] = carry.stack.data_ptr()
        if carry.u2e is not None or carry.o2e is not None:
            if edge.form != "raw":
                raise ValueError("the neighbour stacks are carried only for raw edges")
            _check("u2e", carry.u2e, edge_shape, dt, dev)
            _check("o2e", carry.o2e, edge_shape, dt, dev)
            cptr[1], cptr[2] = carry.u2e.data_ptr(), carry.o2e.data_ptr()
        if tail is not None:
            _check("step", carry.step, (), dt, dev)
            cptr[3] = carry.step.data_ptr()
            if carry.alpha is not None:
                if not softmax_mode or L > MAX_CARRY_L:
                    raise ValueError(f"alpha is carried for softmax_natural at L <= "
                                     f"{MAX_CARRY_L}")
                _check("alpha", carry.alpha, (L,), dt, dev)
                cptr[4] = carry.alpha.data_ptr()
    ptrs = (ctypes.c_void_p * 43)(
        *(getattr(state, f).data_ptr() for f in _STATE), state.rou.data_ptr(),
        planes.data_ptr(), alpha.data_ptr(), T.data_ptr(), step.data_ptr(),
        interior.data_ptr(), _predicate("active", active, dev), _predicate("stop", stop, dev),
        *nodes, *(x.data_ptr() for x in edge.fields), part.data_ptr(), *tptr, *cptr)
    lo_u = lo_v = 0.0
    if node.form == "modes":
        lo_u, lo_v = node.cos.lo_u, node.cos.lo_v
    dconsts = (ctypes.c_double * 29)(
        *consts, cfg.alpha_lr_scale, cfg.drate, cfg.t_floor,
        float(0 if tail is None else tail.n_interior), cfg.tor, W_CLIP, lo_u, lo_v,
        _inv_tau(cfg, dt), cfg.step0)
    ints = (ctypes.c_int * 13)(
        NODE_FORMS.index(node.form), EDGE_FORMS.index(edge.form), L, M, N,
        -1 if colour is None else colour, _int32(cfg.alpha_start), _int32(cfg.anneal_every),
        _int32(cfg.its), cap, softmax_mode, int(cfg.step_const), int(max_ctas))
    lib = build.library_for(dev)
    fn = lib.gqmap_site_update_v2_f32 if dt == torch.float32 else lib.gqmap_site_update_v2_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(fn(ctypes.addressof(ptrs), ctypes.addressof(dconsts), ctypes.addressof(ints),
                   dev.index, stream), "site_update_cuda")
    site_update_cuda.launches += 1
    if tail is None:
        return planes, part
    sweep_tail_v2.launches += 1
    return planes, part, res


site_update_cuda.launches = 0


class _Counted:
    """A launch counter of work that runs inside another kernel's launch."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


# K9 v2: the tail that K8 v2's last CTA runs; site_update_cuda adds one here
# where it launches K8 v2 with a tail
sweep_tail_v2 = _Counted("sweep_tail_v2")

_TICKETS = {}  # device -> K8 v2's ticket counter (each tail leaves it at 0)


def _ticket(dev) -> torch.Tensor:
    t = _TICKETS.get(dev)
    if t is None:
        t = _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _int32(x: int) -> int:
    return max(-2 ** 31, min(int(x), 2 ** 31 - 1))


def sweep_tail_cuda(parts, state, step, cfg, n_interior: int, active=None, loop=None):
    """Kernel K9 on the partials of the sweep's passes (one, or red-black's
    two), for any number of components L. Returns ``(w, T, it, (energy, ptdmu,
    ptdsigma, dalpha))``, the last four views of one tensor. ``loop = (n,
    stop, bufs)``, the device loop's sweep count, stop flag and ``(3, cap)``
    traces: the sweep is predicated on ``~stop``, the new w, T and it are
    written into ``state``'s own tensors (which are returned) and, where the
    sweep ran, the traces go to slot ``n``, the stop rule (``ptdmu < tor``
    or ``it > its``) may set ``stop`` and ``n`` advances."""
    w = state.w
    if w.device.type != "cuda":
        raise RuntimeError(f"sweep_tail_cuda needs CUDA tensors, got {w.device}")
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep_tail_cuda takes float32 or float64, not {w.dtype}")
    if w.ndim != 1 or w.shape[0] < 1:
        raise ValueError(f"w must be (L,) with L >= 1, got {tuple(w.shape)}")
    if len(parts) not in (1, 2):
        raise ValueError(f"one or two passes' partials, got {len(parts)}")
    dt, dev, L = w.dtype, w.device, w.shape[0]
    G = parts[-1].shape[1] if parts[-1].ndim == 3 else -1
    for k, p in enumerate(parts):
        _check(f"partials {k}", p, (L, G, 4), dt, dev)
    _check("T", state.temperature, (), dt, dev)
    _check("it", state.it, (), torch.int32, dev)
    _check("step", step, (), dt, dev)
    stop, cap = None, 1
    if loop is not None:
        if active is not None:
            raise ValueError("the device loop's predicate is its stop flag: pass no active")
        n, stop, bufs = loop
        _check("n", n, (), torch.int64, dev)
        _check("stop", stop, (), torch.bool, dev)
        if bufs.ndim != 2 or bufs.shape[0] != 3:
            raise ValueError(f"bufs must be (3, cap), got {tuple(bufs.shape)}")
        cap = bufs.shape[1]
        _check("bufs", bufs, (3, cap), dt, dev)
        outs = (w, state.temperature, state.it)
    else:
        outs = (torch.empty_like(w), torch.empty_like(state.temperature),
                torch.empty_like(state.it))
    _check("w", w, (L,), dt, dev)
    aux = torch.empty(3 + 2 * L, dtype=dt, device=dev)  # SweepAux, dalpha, K9's scratch
    ptrs = (ctypes.c_void_p * 15)(
        parts[0].data_ptr() if len(parts) == 2 else None, parts[-1].data_ptr(), w.data_ptr(),
        state.temperature.data_ptr(), step.data_ptr(), state.it.data_ptr(),
        _predicate("active", active, dev), None if stop is None else stop.data_ptr(),
        *(x.data_ptr() for x in outs), aux.data_ptr(),
        *((None, None, None) if loop is None else (n.data_ptr(), stop.data_ptr(),
                                                    bufs.data_ptr())))
    consts = (ctypes.c_double * 6)(cfg.alpha_lr_scale, cfg.drate, cfg.t_floor,
                                   float(n_interior), cfg.tor, W_CLIP)
    lib = build.library_for(dev)
    fn = lib.gqmap_sweep_tail_f32 if dt == torch.float32 else lib.gqmap_sweep_tail_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(fn(ctypes.addressof(ptrs), ctypes.addressof(consts), L, G,
                   _int32(cfg.alpha_start), _int32(cfg.anneal_every), _int32(cfg.its), cap,
                   int(cfg.alpha_update == "softmax_natural"), dev.index, stream),
                "sweep_tail_cuda")
    sweep_tail_cuda.launches += 1
    return (*outs, (*aux[:3].unbind(0), aux[3:3 + L]))


sweep_tail_cuda.launches = 0
