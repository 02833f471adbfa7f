"""Bicubic (cubic-convolution) image sampling, MATLAB ``interp2('cubic')`` parity.

Port of ``gqmap_tpu/ops/interp.py`` (``pad_cubic``, ``sample_bicubic``): the
cubic-extrapolated padding of ``getVV`` (``gqmap_gpu_mixture.m:191-208``)
and the 16-tap Keys-kernel sum of ``node_pot`` (``:156-179``), as one flat
gather over a stacked tap-offset axis. Coordinates are MATLAB 1-based: a
query at ``(Xq, Yq) == (j, i)`` returns ``V[i-1, j-1]`` exactly.
"""

from __future__ import annotations

import torch

__all__ = ["pad_cubic", "sample_bicubic"]


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
    # 0-based top-left corner of the 4x4 patch in VV: row iy-1, col ix-1
    base = (iy.long() - 1) * N2 + (ix.long() - 1)

    wy = _cubic_weights(to)
    wx = _cubic_weights(so)
    offs = torch.tensor([dr * N2 + dc for dc in range(4) for dr in range(4)],
                        dtype=torch.long, device=VV.device)
    offs = offs.reshape((16,) + (1,) * base.ndim)
    taps = VV.reshape(-1)[offs + base[None]]  # (16,) + shape
    Vq = torch.zeros_like(Xq)
    k = 0
    for dc in range(4):
        for dr in range(4):
            Vq = Vq + taps[k] * (wx[dc] * wy[dr])
            k += 1
    return Vq * 0.25
