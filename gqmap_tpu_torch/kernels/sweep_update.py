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
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..ops.cosine import CosData, _finalize_mode_sums
from ..ops.gq import (_CONST1, _SQRT2, EDGE, NODE, GQChainRaw, GQGrads, GQRaw, finalize,
                      finalize_chain)
from ..ops.simplex import project_simplex, softmax_natural_step
from . import build
from .edge_reduced_gq import neighbour_stacks

__all__ = ["NODE_FORMS", "EDGE_FORMS", "NodeSums", "EdgeSums", "CTA_SITES", "TAIL_THREADS",
           "W_CLIP", "lattice_views", "stack2", "site_update_cuda", "site_update_torch",
           "step_torch", "sweep_tail_cuda", "sweep_tail_torch", "site_consts",
           "partial_blocks"]

NODE_FORMS = ("modes", "raw", "chain")  # K8's node instances, codes 0, 1, 2
EDGE_FORMS = ("grads", "raw")           # K8's edge instances, codes 0, 1
CTA_SITES = 256     # K8: sites a CTA, each CTA one partial
TAIL_THREADS = 512  # K9's one CTA
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
    """K8's CTAs a component, ``G``: its partials are ``(L, G, 4)``."""
    return -(-M * N // CTA_SITES)


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
                     rng, colour: int | None = None, active=None, stop=None):
    """Kernel K8: one pass over the sites ``interior & active & ~stop`` of
    colour ``colour`` (None: every site; 0: red, ``(m + n)`` even; 1: black).
    Returns the new ``(9, L, M, N)`` state buffer (:func:`lattice_views`) and
    the ``(L, G, 4)`` partials (energy, dalpha, sum |dmuu|, sum |dsigmau| of
    each CTA). ``alpha`` (``(L,)``), ``T`` and ``step`` (``()``) are tensors
    on the card: the kernel reads them through pointers."""
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
    G = partial_blocks(M, N)
    planes = torch.empty((9, L, M, N), dtype=dt, device=dev)
    part = torch.empty((L, G, 4), dtype=dt, device=dev)
    nodes = [x.data_ptr() for x in node.fields] + [None] * (7 - len(node.fields))
    ptrs = (ctypes.c_void_p * 27)(
        *(getattr(state, f).data_ptr() for f in _STATE), state.rou.data_ptr(),
        planes.data_ptr(), alpha.data_ptr(), T.data_ptr(), step.data_ptr(),
        interior.data_ptr(), _predicate("active", active, dev), _predicate("stop", stop, dev),
        *nodes, *(x.data_ptr() for x in edge.fields), part.data_ptr())
    consts = (ctypes.c_double * 19)(*(float(c) for c in site_consts(node, cfg, rng)))
    lib = build.library_for(dev)
    fn = lib.gqmap_site_update_f32 if dt == torch.float32 else lib.gqmap_site_update_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(fn(ctypes.addressof(ptrs), ctypes.addressof(consts),
                   NODE_FORMS.index(node.form), EDGE_FORMS.index(edge.form), L, M, N,
                   -1 if colour is None else colour, dev.index, stream), "site_update_cuda")
    site_update_cuda.launches += 1
    return planes, part


site_update_cuda.launches = 0


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
