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

__all__ = ["pad_cubic", "sample_bicubic", "interp2_cubic", "upsample_cubic", "phase_weights",
           "prewitt_gradients", "interp2_linear", "fill_missing_nearest"]


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


def sample_bicubic(VV: torch.Tensor, Xq, Yq) -> torch.Tensor:
    """Sample the cubic-padded image ``VV = pad_cubic(V)`` at 1-based points.

    ``Xq``/``Yq`` broadcast together; queries are clamped to ``[1, N] x
    [1, M]`` as ``node_pot`` does (``gqmap_gpu_mixture.m:157-161``).
    """
    M2, N2 = VV.shape
    M, N = M2 - 2, N2 - 2
    Xq, Yq = torch.broadcast_tensors(torch.as_tensor(Xq, dtype=VV.dtype, device=VV.device),
                                     torch.as_tensor(Yq, dtype=VV.dtype, device=VV.device))
    Xq = Xq.clamp(1.0, N)
    Yq = Yq.clamp(1.0, M)
    # ix in [1, N-1]: floor for Xq <= N-1, else N-1 (the reference's
    # three-way branch, since Xq >= 1 after the clamp).
    ix = torch.clamp(torch.floor(Xq), max=N - 1.0)
    iy = torch.clamp(torch.floor(Yq), max=M - 1.0)
    so = Xq - ix
    to = Yq - iy
    # 0-based top-left corner of the 4x4 patch in VV: row iy-1, col ix-1. A NaN
    # query's index becomes 0, as XLA converts it, so the gather stays in range
    # and the NaN weights carry the NaN into its result, as in the JAX package.
    base = (_index(iy) - 1) * N2 + (_index(ix) - 1)

    wy = _cubic_weights(to)
    wx = _cubic_weights(so)
    offs = _tap_offsets(N2, VV.device).reshape((16,) + (1,) * base.ndim)
    taps = VV.reshape(-1)[offs + base[None]]  # (16,) + shape
    Vq = torch.zeros_like(Xq)
    k = 0
    for dc in range(4):
        for dr in range(4):
            Vq = Vq + taps[k] * (wx[dc] * wy[dr])
            k += 1
    return Vq * 0.25


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
