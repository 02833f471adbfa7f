"""The explicit halo sweep on ``torch.distributed``.

Port of ``gqmap_tpu/parallel/halo.py``. The lattice is block-sharded over the
``(x, y)`` mesh axes, one rank a block. Each neighbour roll of the sweep
exchanges exactly one boundary row or column with the ring neighbour
(:func:`halo_roll`, ``batch_isend_irecv``), and each pass's energy, alpha
gradient and |dmu| / |dsigma| sums are summed over the ``(x, y)`` ranks in one
``all_reduce`` (:func:`psum`). Every kernel (K1, K2, K3) runs on the rank's
own block: K2, which reads its neighbour in place, gets the row below and
the column to the right of its block as a halo (:func:`halo_edges`).

Semantics are the single-device sweep's: the wrap-around halo reproduces
``circshift``, and the frozen border ring makes the wrap's contribution
inert, as in the reference (``gqmap_gpu_mixture.m:37-46``).

Under gloo a CUDA tensor's slices are staged through pinned host buffers
(gloo's point-to-point operations take host memory); under NCCL they go
from card to card. A failed exchange raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import GQMAPConfig
from ..models.gqmap import DistHooks, flow_lattice_shape, make_sweep
from .mesh import Mesh, Ring

__all__ = ["HaloRoll", "halo_roll", "halo_edges", "psum", "all_gather_blocks",
           "make_halo_sweep"]


def _staged(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` goes through a pinned host buffer: a CUDA tensor under gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)  # waits for the card: the send reads the buffer next
    return buf


def _exchange(send: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send ``send`` to rank ``to`` and receive a tensor of its shape from rank
    ``frm``, together; the received tensor is on ``send``'s device."""
    send = send.contiguous()
    staged = _staged(send)
    out = _to_host(send) if staged else send
    recv = torch.empty(out.shape, dtype=out.dtype, device=out.device,
                       pin_memory=staged)
    ops = [dist.P2POp(dist.isend, out, to), dist.P2POp(dist.irecv, recv, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(send.device, non_blocking=True) if staged else recv


def _first(x: torch.Tensor, axis: int, ring: Ring) -> torch.Tensor:
    """The next shard's first slice along ``axis`` (``x[n]`` of the global
    array, for this block of ``n`` slices)."""
    return _exchange(x.narrow(axis, 0, 1), ring.prev, ring.next)


def _last(x: torch.Tensor, axis: int, ring: Ring) -> torch.Tensor:
    """The previous shard's last slice along ``axis`` (``x[-1]`` of the global
    array)."""
    return _exchange(x.narrow(axis, x.shape[axis] - 1, 1), ring.next, ring.prev)


class HaloRoll(torch.autograd.Function):
    """:func:`halo_roll` with its gradient: the roll back, ``halo_roll(grad,
    -shift)``, so ``torch.autograd`` differentiates through the exchange (the
    autodiff estimator on a shard)."""

    @staticmethod
    def forward(ctx, x, shift, axis, ring):
        ctx.shift, ctx.axis, ctx.ring = shift, axis, ring
        if ring.n == 1:
            return torch.roll(x, shift, axis)
        n = x.shape[axis]
        if shift == -1:  # out[i] = x[i+1]: my first slice goes to the previous rank
            return torch.cat([x.narrow(axis, 1, n - 1), _first(x, axis, ring)], axis)
        # out[i] = x[i-1]: my last slice goes to the next rank
        return torch.cat([_last(x, axis, ring), x.narrow(axis, 0, n - 1)], axis)

    @staticmethod
    def backward(ctx, grad):
        return HaloRoll.apply(grad, -ctx.shift, ctx.axis, ctx.ring), None, None, None


def halo_roll(x: torch.Tensor, shift: int, axis: int, ring: Ring | None = None) -> torch.Tensor:
    """Global ``torch.roll(x, shift, axis)`` over an axis split along ``ring``.

    Only +-1 shifts (the stencil's halo) are supported: one boundary slice is
    exchanged with the ring neighbour, the rest is a local shift. With one
    shard (or no ring) it is ``torch.roll``. Differentiable (:class:`HaloRoll`).
    """
    if ring is None or ring.n == 1:
        return torch.roll(x, shift, axis)
    if shift not in (-1, 1):
        raise ValueError(f"halo_roll supports shift +-1, got {shift}")
    return HaloRoll.apply(x, shift, axis, ring)


def halo_edges(x: torch.Tensor, ring_x: Ring | None, ring_y: Ring | None):
    """The state one row below this block and one column to its right, with
    wrap: ``(down, right)``, ``x[..., M, :N]`` and ``x[..., :M, N]`` of the global
    array around this ``(..., M, N)`` block; two exchanges, one slice each."""
    if ring_x is None or ring_x.n == 1:
        down = x[..., :1, :]
    else:
        down = _first(x, -2, ring_x)
    if ring_y is None or ring_y.n == 1:
        right = x[..., :, :1]
    else:
        right = _first(x, -1, ring_y)
    return down, right


def psum(v: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``v`` over the ranks of ``group`` (one ``all_reduce``)."""
    staged = _staged(v, group)
    buf = _to_host(v) if staged else v.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(v.device, non_blocking=True) if staged else buf


def all_gather_blocks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole lattice from every ``(x, y)`` rank's ``(..., ml, nl)`` block of
    this rank's ``dp`` index, on every one of them."""
    group = mesh.xy_group()
    px, py = mesh.shape["x"], mesh.shape["y"]
    staged = _staged(x, group)
    src = _to_host(x.contiguous()) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(px * py)]
    dist.all_gather(parts, src, group=group)
    rows = [torch.cat(parts[i * py:(i + 1) * py], -1) for i in range(px)]
    whole = torch.cat(rows, -2)
    return whole.to(x.device) if staged else whole


def make_halo_sweep(cfg: GQMAPConfig, image_shape, mesh: Mesh):
    """The sweep of this rank's block: ``sweep(local_problem, local_state) ->
    (local_state, SweepAux)``, SweepAux summed over the ``(x, y)`` ranks.

    The lattice must divide the mesh (else ``ValueError``). ``local_problem``
    holds the whole frames and this rank's block of the interior mask, the
    cosine coefficient field and the quadratic prior's init flow
    (:func:`gqmap_tpu_torch.parallel.sharded.shard_problem`); the node term
    takes frame 1's block at the shard's origin.
    """
    M, N = flow_lattice_shape(cfg, image_shape)
    ml, nl = mesh.block(M, N)
    ring_x, ring_y = mesh.ring("x"), mesh.ring("y")
    origin = mesh.origin(M, N)

    def roll(x, shift, axis):
        ax = x.ndim + axis if axis < 0 else axis
        if ax == x.ndim - 2:
            return halo_roll(x, shift, -2, ring_x)
        if ax == x.ndim - 1:
            return halo_roll(x, shift, -1, ring_y)
        raise ValueError(axis)

    hooks = DistHooks(roll=roll, psum=lambda v: psum(v, mesh.xy_group()),
                      origin=lambda: origin, local_lattice=(ml, nl),
                      halo=lambda x: halo_edges(x, ring_x, ring_y))
    return make_sweep(cfg, image_shape, dist=hooks)
