"""Bicubic (cubic-convolution) image sampling, MATLAB ``interp2('cubic')`` parity.

Port of ``gqmap_tpu/ops/interp.py``: the cubic-extrapolated padding of
``getVV`` (``gqmap_gpu_mixture.m:191-208``) and the 16-tap Keys-kernel sum of
``node_pot`` (``:156-179``), as one flat gather over a stacked tap-offset
axis; the 2^rfc-x grid refinement of the legacy nearest-lookup data term
(:func:`upsample_cubic`) and the Prewitt gradients of its chain-rule
estimator; the bilinear warp of the coarse-to-fine driver
(:func:`interp2_linear`, :func:`fill_missing_nearest`). Coordinates are
MATLAB 1-based: a query at ``(Xq, Yq) == (j, i)`` returns ``V[i-1, j-1]``
exactly.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["pad_cubic", "sample_bicubic", "sample_bicubic_grad", "clip", "clip_slope",
           "interp2_cubic", "upsample_cubic", "phase_weights", "prewitt_gradients",
           "interp2_linear", "fill_missing_nearest"]


def pad_cubic(V: torch.Tensor) -> torch.Tensor:
    """Pad a 2-D image by one cubic-extrapolated ring (``getVV``).

    Top and bottom rows of every column first (including the still-zero side
    columns), then the left and right columns of every row from the already
    extrapolated inner columns, so corners match MATLAB's two-pass order.
    """
    M, N = V.shape
    out = V.new_zeros((M + 2, N + 2))
    out[1:-1, 1:-1] = V
    top = (3.0 * out[1, :] - 3.0 * out[2, :]) + out[3, :]
    bot = (3.0 * out[-2, :] - 3.0 * out[-3, :]) + out[-4, :]
    out[0, :] = top
    out[-1, :] = bot
    left = (3.0 * out[:, 1] - 3.0 * out[:, 2]) + out[:, 3]
    right = (3.0 * out[:, -2] - 3.0 * out[:, -3]) + out[:, -4]
    out[:, 0] = left
    out[:, -1] = right
    return out


def _index(x: torch.Tensor) -> torch.Tensor:
    """``x.long()`` with NaN taken to 0, XLA's conversion of a NaN: the gathers
    of a NaN query then read an element in range (negative indices wrap)."""
    return torch.nan_to_num(x, nan=0.0).long()


@functools.lru_cache(maxsize=None)
def _tap_offsets(N2: int, device: torch.device) -> torch.Tensor:
    """The 16 flat offsets ``dr N2 + dc`` of a 4x4 patch in a table of row
    length ``N2``, column-major as the taps are summed; made once a (row
    length, device), so a sample copies nothing from the host."""
    return torch.tensor([dr * N2 + dc for dc in range(4) for dr in range(4)],
                        dtype=torch.long, device=device)


def _cubic_weights(f):
    """The four cubic-convolution weights of MATLAB interp2: 2x the Keys
    (a=-1/2) kernel at ``1+f, f, 1-f, 2-f``, so the product of an x- and a
    y-weight is 4x, undone by the final ``/4`` in :func:`sample_bicubic`."""
    w0 = ((2.0 - f) * f - 1.0) * f
    w1 = (3.0 * f - 5.0) * f * f + 2.0
    w2 = ((4.0 - 3.0 * f) * f + 1.0) * f
    w3 = (f - 1.0) * f * f
    return w0, w1, w2, w3


def _cubic_slopes(f):
    """The derivatives of :func:`_cubic_weights` with respect to ``f``."""
    d0 = (4.0 - 3.0 * f) * f - 1.0
    d1 = (9.0 * f - 10.0) * f
    d2 = (8.0 - 9.0 * f) * f + 1.0
    d3 = (3.0 * f - 2.0) * f
    return d0, d1, d2, d3


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``min(max(x, lo), hi)`` against tensor bounds,
    NaN kept. Its values are ``x.clamp(lo, hi)``'s; its derivative is JAX's,
    1/2 where ``x`` lies on a bound (the tie rule of ``lax.max`` and
    ``lax.min``), where ``clamp``'s is 1. The bounds are filled on the device,
    so a graph capture copies nothing from the host."""
    def bound(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def clip_slope(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """The derivative of :func:`clip` at ``x``, as JAX differentiates
    ``jnp.clip``: 1 inside, 1/2 on a bound, 0 outside and at a NaN."""
    def slope(above, on):
        return torch.where(above, 1.0, torch.where(on, 0.5, 0.0)).to(x.dtype)

    y = torch.clamp(x, min=lo)
    return slope(x > lo, x == lo) * slope(y < hi, y == hi)


def _bicubic_cells(VV: torch.Tensor, Xq, Yq):
    """The queries broadcast together (before the clip), the fractions of
    the clipped ones in their cell, and the (16,) + shape taps of VV around
    them, as :func:`sample_bicubic` reads them."""
    M2, N2 = VV.shape
    M, N = M2 - 2, N2 - 2
    Xq, Yq = torch.broadcast_tensors(torch.as_tensor(Xq, dtype=VV.dtype, device=VV.device),
                                     torch.as_tensor(Yq, dtype=VV.dtype, device=VV.device))
    Xc = clip(Xq, 1.0, N)
    Yc = clip(Yq, 1.0, M)
    # ix in [1, N-1]: floor for Xq <= N-1, else N-1 (the reference's
    # three-way branch, since Xq >= 1 after the clamp).
    ix = torch.clamp(torch.floor(Xc), max=N - 1.0)
    iy = torch.clamp(torch.floor(Yc), max=M - 1.0)
    so = Xc - ix
    to = Yc - iy
    # 0-based top-left corner of the 4x4 patch in VV: row iy-1, col ix-1. A NaN
    # query's index becomes 0, as XLA converts it, so the gather stays in range
    # and the NaN weights carry the NaN into its result, as in the JAX package.
    base = (_index(iy) - 1) * N2 + (_index(ix) - 1)
    offs = _tap_offsets(N2, VV.device).reshape((16,) + (1,) * base.ndim)
    return Xq, Yq, so, to, VV.reshape(-1)[offs + base[None]]


def sample_bicubic(VV: torch.Tensor, Xq, Yq) -> torch.Tensor:
    """Sample the cubic-padded image ``VV = pad_cubic(V)`` at 1-based points.

    ``Xq``/``Yq`` broadcast together; queries are clamped to ``[1, N] x
    [1, M]`` as ``node_pot`` does (``gqmap_gpu_mixture.m:157-161``), by
    :func:`clip`, so ``torch.autograd`` differentiates a query on the clamp as
    ``jax.grad`` does.
    """
    Xq, _, so, to, taps = _bicubic_cells(VV, Xq, Yq)
    wy = _cubic_weights(to)
    wx = _cubic_weights(so)
    Vq = torch.zeros_like(Xq)
    k = 0
    for dc in range(4):
        for dr in range(4):
            Vq = Vq + taps[k] * (wx[dc] * wy[dr])
            k += 1
    return Vq * 0.25


def sample_bicubic_grad(VV: torch.Tensor, Xq, Yq):
    """:func:`sample_bicubic` with its derivatives: ``(V, dV/dXq, dV/dYq)``,
    ``V`` bit for bit :func:`sample_bicubic`'s. The derivatives are the ones
    ``jax.grad`` takes of the JAX function: the Keys weights' slopes at the
    fractions, the floor without one, and the clamp's :func:`clip_slope`
    (1/2 for a query on the frame's edge)."""
    M2, N2 = VV.shape
    Xq, Yq, so, to, taps = _bicubic_cells(VV, Xq, Yq)
    wy, wx = _cubic_weights(to), _cubic_weights(so)
    dy, dx = _cubic_slopes(to), _cubic_slopes(so)
    Vq = torch.zeros_like(Xq)
    Vx = torch.zeros_like(Xq)
    Vy = torch.zeros_like(Xq)
    k = 0
    for dc in range(4):
        for dr in range(4):
            Vq = Vq + taps[k] * (wx[dc] * wy[dr])
            Vx = Vx + taps[k] * (dx[dc] * wy[dr])
            Vy = Vy + taps[k] * (wx[dc] * dy[dr])
            k += 1
    return (Vq * 0.25, Vx * (0.25 * clip_slope(Xq, 1.0, N2 - 2)),
            Vy * (0.25 * clip_slope(Yq, 1.0, M2 - 2)))


def prewitt_gradients(V: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Prewitt spatial gradients ``(Gx, Gy)`` of a 2-D image, ``Gx = dV/dx``
    (x = columns), ``Gy = dV/dy`` (y = rows): a central difference along the
    derivative axis smoothed by a 3-tap box along the other, normalised by
    1/6 to a true derivative estimate; replicate-padded edges
    (``legacy/gqmap_gpuV3.m:18``)."""
    def pad(x, rows, cols):  # edge padding of a 2-D array
        return torch.nn.functional.pad(x[None], (cols, cols, rows, rows), mode="replicate")[0]

    Vp = pad(V, 1, 1)
    box_rows = (Vp[:-2, 1:-1] + Vp[1:-1, 1:-1] + Vp[2:, 1:-1]) / 3.0
    box_cols = (Vp[1:-1, :-2] + Vp[1:-1, 1:-1] + Vp[1:-1, 2:]) / 3.0
    bp = pad(box_rows, 0, 1)
    Gx = (bp[:, 2:] - bp[:, :-2]) / 2.0
    bq = pad(box_cols, 1, 0)
    Gy = (bq[2:, :] - bq[:-2, :]) / 2.0
    return Gx, Gy


def interp2_cubic(V: torch.Tensor, Xq, Yq) -> torch.Tensor:
    """MATLAB ``interp2(V, Xq, Yq, 'cubic')`` for in-range 1-based queries."""
    return sample_bicubic(pad_cubic(V), Xq, Yq)


def upsample_cubic(V: torch.Tensor, rfc: int) -> torch.Tensor:
    """MATLAB ``interp2(V, rfc, 'cubic')``: 2^rfc-x grid refinement.

    Returns shape ``((M-1) 2^rfc + 1, (N-1) 2^rfc + 1)``, ``V`` interpolated
    at spacing ``2^-rfc`` (``legacy/gqmap_gpuV2.m:10``). The refined grid is
    regular, so the fractional offset cycles with period ``r = 2^rfc`` and
    each pass is a separable phase stencil: per phase, a 4-tap weighted sum
    of shifted rows (then columns). At 376x452 and rfc = 6 the result holds
    6.9e8 values, so the horizontal pass accumulates its four taps in place
    into the output (a strided ``(rows, N-1, r)`` view of it, ``addcmul_``
    of broadcast operands) and the peak stays one table plus the small
    vertically refined field; each tap is added in the JAX function's order.
    """
    M, N = V.shape
    r = 1 << rfc
    VV = pad_cubic(V)
    w = phase_weights(rfc, V.dtype, V.device)  # (4, r)

    # vertical pass: base row iy = 1 + i (i in 0..M-2) uses VV rows i .. i+3
    rows = (M - 1) * r + 1
    vert = V.new_zeros((rows, N + 2))
    vv = vert[:-1].unflatten(0, (M - 1, r))  # (M-1, r, N+2)
    for t in range(4):
        vv.addcmul_(w[t][None, :, None], VV[t:t + M - 1, :][:, None, :])
    vert[-1] = VV[M]  # the exact last row

    # horizontal pass on the vertically refined field, into the output
    out = V.new_zeros((rows, (N - 1) * r + 1))
    hv = out[:, :-1].unflatten(1, (N - 1, r))  # (rows, N-1, r), strided
    for t in range(4):
        hv.addcmul_(w[t][None, None, :], vert[:, t:t + N - 1][:, :, None])
    out[:, -1] = vert[:, N]  # the exact last column
    return out


def phase_weights(rfc: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The ``(4, 2^rfc)`` cubic weights of :func:`upsample_cubic`'s phase
    stencil, halved: row ``t``, column ``p`` weighs tap ``t`` at the fractional
    offset ``p / 2^rfc``. A table cell ``(ci, cj)`` below the last row and
    column is, with ``(iy, py) = divmod(ci, r)`` and ``(ix, px) = divmod(cj, r)``,
    the fused multiply-add chain ``sum_t w[t, px] vert(ci, ix + t)`` (tap 0
    first, from 0) over ``vert(ci, col) = sum_t w[t, py] VV[iy + t, col]``,
    ``VV = pad_cubic(V)``; the last row reads ``vert = VV[M, col]``, the last
    column ``vert(ci, N)``: ``addcmul_`` rounds each step once, on the CPU and
    on the H100. Kernel K6's and K7's ``"v2"`` evaluate cells so, from the
    weights this function gives, bit for bit the table's."""
    r = 1 << rfc
    fr = torch.arange(r, dtype=dtype, device=device) / r
    return torch.stack([x * 0.5 for x in _cubic_weights(fr)])


def interp2_linear(V: torch.Tensor, Xq, Yq, fill=math.nan) -> torch.Tensor:
    """MATLAB ``interp2(V, Xq, Yq)`` (bilinear, ``fill`` outside the grid).

    Used by the coarse-to-fine warper (``legacy/optical_flow_ctf.m:31``).
    1-based query coordinates; the cell index is clipped to ``[1, N-1]``, so
    a query exactly on the last row or column takes the last cell with
    weight 1 on its far side.
    """
    M, N = V.shape
    Xq, Yq = torch.broadcast_tensors(torch.as_tensor(Xq, dtype=V.dtype, device=V.device),
                                     torch.as_tensor(Yq, dtype=V.dtype, device=V.device))
    inb = (Xq >= 1) & (Xq <= N) & (Yq >= 1) & (Yq <= M)
    x = Xq.clamp(1.0, N)
    y = Yq.clamp(1.0, M)
    ix = x.floor().clamp(1, N - 1)
    iy = y.floor().clamp(1, M - 1)
    fx = x - ix
    fy = y - iy
    idx = (_index(iy) - 1) * N + (_index(ix) - 1)
    flat = V.reshape(-1)

    def tap(di, dj):
        return flat[idx + di * N + dj]

    val = (tap(0, 0) * (1 - fy) * (1 - fx)
           + tap(0, 1) * (1 - fy) * fx
           + tap(1, 0) * fy * (1 - fx)
           + tap(1, 1) * fy * fx)
    return torch.where(inb, val, torch.full_like(val, fill))


def fill_missing_nearest(A: torch.Tensor) -> torch.Tensor:
    """``fillmissing(fillmissing(A,'nearest',1),'nearest',2)``.

    Replaces NaNs by the nearest non-NaN along axis 0, then along axis 1
    (``legacy/optical_flow_ctf.m:32``). At equal distance the following
    element wins (the backward fill), as in MATLAB's 'nearest'. A line with
    no valid entry stays as it is.
    """

    def fill_axis(B, axis):
        n = B.shape[axis]
        shape = [1, 1]
        shape[axis] = n
        idx = torch.arange(n, device=B.device).reshape(shape).expand_as(B)
        ok = ~torch.isnan(B)
        # forward fill: last valid index at or before i
        fwd = torch.where(ok, idx, -1).cummax(axis).values
        # backward fill: first valid index at or after i (a cummax of the
        # negated indices over the reversed axis)
        neg = torch.where(ok, -idx, -(n + 1)).flip(axis)
        bwd = -neg.cummax(axis).values.flip(axis)
        dist_f = torch.where(fwd >= 0, idx - fwd, n + 1)
        dist_b = torch.where(bwd <= n, bwd - idx, n + 1)
        pick = torch.where(dist_b <= dist_f, bwd.clamp(0, n - 1), fwd.clamp(0, n - 1))
        return torch.gather(B, axis, pick)

    return fill_axis(fill_axis(A, 0), 1)
