"""MRF potentials (port of ``gqmap_tpu/ops/potentials.py``).

Node (data) potential: Charbonnier brightness constancy against a bicubically
sampled second frame (``gqmap_gpu_mixture.m:156-179``): the exact path's node
term (through :func:`gqmap_tpu_torch.ops.gq.gq_accumulate`) and the logP
readout. Edge (smoothness) potential: Charbonnier on the neighbour flow
difference (``:180-182``), in its two-endpoint and difference forms.

The legacy families:

* ``make_node_pot_nearest`` -- nearest lookup into a 2^rfc-x cubic-upsampled
  frame (``legacy/gqmap_gpuV2.m:10,107``), and its chain-rule form for the
  Prewitt estimator (``legacy/gqmap_gpuV3.m:91-125``);
* ``make_node_pot_windowed`` -- the mean cost over a (2rg+1)^2 window
  (``legacy/gqmap_cpuV2.m:29-33``), and with its exact derivatives for the
  autodiff estimator's kernel K16 (``make_node_pot_windowed_chain``);
* a quadratic node prior toward an init flow and truncated-quadratic edges
  (``legacy/gqmap_cpu.m:22-23,43``).

The lookup index ``floor((pos - 1) 2^rfc + 1.5)`` is clamped and flattened in
int64 (the 376x452 table at rfc = 6 holds 6.9e8 values); positions stay far
below 2^24, so float32 resolves every fine-grid cell.
"""

from __future__ import annotations

from typing import Callable

import torch

from .interp import _index, sample_bicubic, sample_bicubic_grad

__all__ = ["make_node_pot_bicubic", "make_node_pot_nearest", "make_node_pot_quadratic",
           "make_node_pot_windowed", "make_node_pot_nearest_chain", "make_node_pot_bicubic_chain",
           "make_node_pot_windowed_chain",
           "make_edge_pot", "make_edge_pot_chain", "make_edge_pot_diff", "make_edge_pot_diff_grad",
           "make_edge_pot_truncquad", "make_edge_pot_truncquad_diff"]


def _grid(I1: torch.Tensor, origin=None, local_image_shape=None):
    """1-based column (1, Nl) and row (Ml, 1) coordinates of the pixels a
    potential covers, and frame 1 there: the whole frame, or on a shard the
    ``local_image_shape`` block at pixel ``origin`` (row, column). Frame 2's
    table always stays whole: a bounded-range lookup may touch any window."""
    Ml, Nl = I1.shape if local_image_shape is None else local_image_shape
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    jj = (1.0 + c0) + torch.arange(Nl, dtype=I1.dtype, device=I1.device).reshape(1, Nl)
    ii = (1.0 + r0) + torch.arange(Ml, dtype=I1.dtype, device=I1.device).reshape(Ml, 1)
    if origin is None and local_image_shape is None:
        return jj, ii, I1
    return jj, ii, I1[r0:r0 + Ml, c0:c0 + Nl]


def _nearest_index(tab_shape, rfc: int):
    """``index(Xq, Yq)``: the flat int64 index of the fine-grid cell nearest
    to 1-based frame position ``(Xq, Yq)`` in a ``2^rfc``-x upsampled table,
    ``round((pos - 1) 2^rfc + 1)`` clamped to the table (``legacy/gqmap_ctf.m:96``;
    MATLAB's round is half away from zero and positions are >= ~1, so
    ``floor(x + 0.5)``). A NaN position takes index 0 before the clamp's
    ``- 1``, as XLA converts it, so the lookup reads the element that the JAX
    package's ``take`` reads there (a negative index wraps)."""
    MM, NN = tab_shape
    r = float(1 << rfc)

    def index(Xq, Yq):
        ci = _index(torch.floor((Yq - 1.0) * r + 1.5).clamp(1, MM)) - 1
        cj = _index(torch.floor((Xq - 1.0) * r + 1.5).clamp(1, NN)) - 1
        return ci * NN + cj

    return index


def make_node_pot_bicubic(I1: torch.Tensor, VV: torch.Tensor, lambdad: float,
                          epsn: float, patch: int = 1, origin=None,
                          local_image_shape=None) -> Callable:
    """Return ``f(x1, x2) -> node potential`` over the ``(Mo, No)`` lattice.

    ``VV = pad_cubic(I2)``; ``x1``/``x2`` are displacements of shape
    ``lead + (M, N)``, ``lead`` any leading broadcast axes (quadrature
    chunk, mixture component), on the flow lattice ``(M, N) = (Mo, No) /
    patch``. For ``patch > 1`` each flow node sums the potential over its
    ``patch x patch`` pixel block (super lattice): the displacements are
    repeated to full resolution, sampled, and summed back per block.

    On a shard, ``origin`` is the image-pixel offset (row, column) of its
    block and ``local_image_shape`` the block's pixel extent: ``f`` then
    covers that block of frame 1 (the JAX package's ``origin`` and
    ``local_image_shape``).
    """
    jj, ii, I1 = _grid(I1, origin, local_image_shape)
    Mo, No = I1.shape

    def f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if patch > 1:
            x1 = x1.repeat_interleave(patch, -2).repeat_interleave(patch, -1)
            x2 = x2.repeat_interleave(patch, -2).repeat_interleave(patch, -1)
        Vq = sample_bicubic(VV, jj + x1, ii + x2)
        npt = -lambdad * torch.sqrt(epsn + (I1 - Vq) ** 2)
        if patch > 1:
            lead = npt.shape[:-2]
            npt = npt.reshape(lead + (Mo // patch, patch, No // patch, patch)).sum((-3, -1))
        return npt

    return f


def make_node_pot_nearest(I1: torch.Tensor, I2_cont: torch.Tensor, lambdad: float,
                          epsn: float, rfc: int, origin=None,
                          local_image_shape=None) -> Callable:
    """Legacy data term: nearest lookup into ``I2_cont = upsample_cubic(I2,
    rfc)`` at the displaced position; ``origin`` and ``local_image_shape`` as
    in :func:`make_node_pot_bicubic`."""
    jj, ii, I1 = _grid(I1, origin, local_image_shape)
    index = _nearest_index(I2_cont.shape, rfc)
    flat = I2_cont.reshape(-1)

    def f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        Vq = flat[index(jj + x1, ii + x2)]
        return -lambdad * torch.sqrt(epsn + (I1 - Vq) ** 2)

    return f


def make_node_pot_windowed(I1: torch.Tensor, tab: torch.Tensor, lambdad: float, epsn: float,
                           rg: int, base: str, rfc: int = 6, origin=None,
                           local_image_shape=None) -> Callable:
    """Overlapping-window data cost (``legacy/gqmap_cpuV2.m:29-33``,
    ``gqmap_cpuV3.m:30-32``): the node potential at pixel (i, j) is the mean
    Charbonnier cost over its (2rg+1)^2 window, the candidate displacement
    shared across the window; frame 1 is edge-padded. ``base`` picks the
    frame-2 sampler: ``"bicubic"`` (``tab = pad_cubic(I2)``) or ``"nearest"``
    (``tab = upsample_cubic(I2, rfc)``). ``origin`` and ``local_image_shape``
    as in :func:`make_node_pot_bicubic`; the window's frame-1 taps come from
    the whole padded frame, so taps across a shard's edge read the true
    neighbours."""
    W = (2 * rg + 1) ** 2
    jj, ii, _ = _grid(I1, origin, local_image_shape)
    Mo, No = ii.shape[0], jj.shape[1]
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    if base == "nearest":
        index = _nearest_index(tab.shape, rfc)
        flat = tab.reshape(-1)

        def sample(Xq, Yq):
            return flat[index(Xq, Yq)]
    elif base == "bicubic":
        def sample(Xq, Yq):
            return sample_bicubic(tab, Xq, Yq)
    else:
        raise ValueError(f"windowed data term needs base bicubic|nearest, got {base!r}")
    I1p = torch.nn.functional.pad(I1[None], (rg, rg, rg, rg), mode="replicate")[0]

    def f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        acc = None
        for di in range(-rg, rg + 1):
            for dj in range(-rg, rg + 1):
                I1s = I1p[r0 + rg + di:r0 + rg + di + Mo, c0 + rg + dj:c0 + rg + dj + No]
                term = torch.sqrt(epsn + (I1s - sample(jj + dj + x1, ii + di + x2)) ** 2)
                acc = term if acc is None else acc + term
        return -lambdad * acc / W

    return f


def make_node_pot_nearest_chain(I1: torch.Tensor, I2_cont: torch.Tensor,
                                I2u_cont: torch.Tensor, I2v_cont: torch.Tensor,
                                lambdad: float, epsn: float, rfc: int, origin=None,
                                local_image_shape=None) -> Callable:
    """Chain-rule node term of the Prewitt estimator family
    (``legacy/gqmap_gpuV3.m:91-125``): ``fg(x1, x2) -> (f, df/dx1, df/dx2)``,
    the spatial derivatives of frame 2 read from the upsampled Prewitt fields
    at the same fine-grid cell as the value,

        f = -lambda_d sqrt(eps + diff^2),   diff = I1 - I2(pos),
        df/dx1 = lambda_d diff I2u(pos) / sqrt(eps + diff^2);

    ``origin`` and ``local_image_shape`` as in :func:`make_node_pot_bicubic`.
    """
    jj, ii, I1 = _grid(I1, origin, local_image_shape)
    index = _nearest_index(I2_cont.shape, rfc)
    flat, flatu, flatv = (x.reshape(-1) for x in (I2_cont, I2u_cont, I2v_cont))

    def fg(x1: torch.Tensor, x2: torch.Tensor):
        idx = index(jj + x1, ii + x2)
        diff = I1 - flat[idx]
        deno = torch.sqrt(epsn + diff * diff)
        s = lambdad * diff / deno
        return -lambdad * deno, s * flatu[idx], s * flatv[idx]

    return fg


def make_node_pot_bicubic_chain(I1: torch.Tensor, VV: torch.Tensor, lambdad: float,
                                epsn: float, patch: int = 1, origin=None,
                                local_image_shape=None) -> Callable:
    """:func:`make_node_pot_bicubic` with its exact derivatives, ``fg(x1, x2)
    -> (f, df/dx1, df/dx2)`` in the form
    :func:`gqmap_tpu_torch.ops.gq.gq_accumulate_chain` takes:

        f = -lambda_d sqrt(eps + diff^2),   diff = I1 - V(c + 1 + x1, r + 1 + x2),
        df/dx1 = lambda_d diff / sqrt(eps + diff^2) dV/dXq,

    ``V`` and its derivatives by :func:`.interp.sample_bicubic_grad`: what
    ``jax.grad`` takes of the JAX potential, with 1/2 for a query on the
    frame's clamp. For ``patch > 1`` a flow node's ``patch x patch`` pixels
    share its displacement, and their ``f`` and derivatives are summed over
    the block as :func:`make_node_pot_bicubic` sums its values. ``f`` is
    :func:`make_node_pot_bicubic`'s bit for bit."""
    jj, ii, I1 = _grid(I1, origin, local_image_shape)
    Mo, No = I1.shape

    def fg(x1: torch.Tensor, x2: torch.Tensor):
        if patch > 1:
            x1 = x1.repeat_interleave(patch, -2).repeat_interleave(patch, -1)
            x2 = x2.repeat_interleave(patch, -2).repeat_interleave(patch, -1)
        Vq, Vx, Vy = sample_bicubic_grad(VV, jj + x1, ii + x2)
        diff = I1 - Vq
        deno = torch.sqrt(epsn + diff ** 2)
        s = lambdad * diff / deno
        out = (-lambdad * deno, s * Vx, s * Vy)
        if patch > 1:
            lead = out[0].shape[:-2]
            out = tuple(x.reshape(lead + (Mo // patch, patch, No // patch, patch)).sum((-3, -1))
                        for x in out)
        return out

    return fg


def make_node_pot_windowed_chain(I1: torch.Tensor, VV: torch.Tensor, lambdad: float,
                                 epsn: float, rg: int, origin=None,
                                 local_image_shape=None) -> Callable:
    """:func:`make_node_pot_windowed` (``base="bicubic"``, ``VV =
    pad_cubic(I2)``) with its exact derivatives, ``fg(x1, x2) -> (f, df/dx1,
    df/dx2)``: over the window's ``W = (2 rg + 1)^2`` taps (di, dj), frame 1
    edge-padded,

        f = -lambda_d / W sum sqrt(eps + diff^2),   diff = I1(r + di, c + dj) - V,
        df/dx1 = lambda_d / W sum diff / sqrt(eps + diff^2) dV/dXq,

    ``V`` at ``(c + 1 + dj + x1, r + 1 + di + x2)`` with its derivatives by
    :func:`.interp.sample_bicubic_grad` (1/2 for a query on the frame's
    clamp, as ``jax.grad`` takes it). ``origin`` and ``local_image_shape`` as
    in :func:`make_node_pot_bicubic`. ``f`` is
    :func:`make_node_pot_windowed`'s bit for bit."""
    W = (2 * rg + 1) ** 2
    jj, ii, _ = _grid(I1, origin, local_image_shape)
    Mo, No = ii.shape[0], jj.shape[1]
    r0, c0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    I1p = torch.nn.functional.pad(I1[None], (rg, rg, rg, rg), mode="replicate")[0]

    def fg(x1: torch.Tensor, x2: torch.Tensor):
        acc = gx = gy = None
        for di in range(-rg, rg + 1):
            for dj in range(-rg, rg + 1):
                I1s = I1p[r0 + rg + di:r0 + rg + di + Mo, c0 + rg + dj:c0 + rg + dj + No]
                Vq, Vx, Vy = sample_bicubic_grad(VV, jj + dj + x1, ii + di + x2)
                term = torch.sqrt(epsn + (I1s - Vq) ** 2)
                q = (I1s - Vq) / term
                if acc is None:
                    acc, gx, gy = term, q * Vx, q * Vy
                else:
                    acc, gx, gy = acc + term, gx + q * Vx, gy + q * Vy
        return -lambdad * acc / W, lambdad * gx / W, lambdad * gy / W

    return fg


def make_node_pot_quadratic(init_flow: torch.Tensor, var: float) -> Callable:
    """Quadratic node potential toward a given ``(M, N, 2)`` init flow
    (``legacy/gqmap_cpu.m:22-23``): ``-((fu-x1)^2 + (fv-x2)^2) / (2 var)``."""
    fu = init_flow[..., 0]
    fv = init_flow[..., 1]

    def f(x1, x2):
        du = fu - x1
        dv = fv - x2
        return -(du * du + dv * dv) * (1.0 / (2.0 * var))

    return f


def make_edge_pot(lambdas: float, epsn: float) -> Callable:
    """Charbonnier smoothness: ``-lambdas * sqrt(epsn + (x1-x2)^2)``."""

    def f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return -lambdas * torch.sqrt(epsn + (x1 - x2) ** 2)

    return f


def make_edge_pot_diff(lambdas: float, epsn: float) -> Callable:
    """Difference form of the Charbonnier edge potential: ``gd(d) = f(d, 0)``."""

    def gd(d: torch.Tensor) -> torch.Tensor:
        return -lambdas * torch.sqrt(epsn + d * d)

    return gd


def make_edge_pot_chain(lambdas: float, epsn: float) -> Callable:
    """:func:`make_edge_pot` with its exact derivatives, ``fg(x1, x2) -> (f,
    g, -g)``, ``g = df/dx1 = -lambdas d / sqrt(epsn + d^2)``, ``d = x1 - x2``."""

    def fg(x1: torch.Tensor, x2: torch.Tensor):
        d = x1 - x2
        deno = torch.sqrt(epsn + d ** 2)
        g = -lambdas * d / deno
        return -lambdas * deno, g, -g

    return fg


def make_edge_pot_diff_grad(lambdas: float, epsn: float) -> Callable:
    """:func:`make_edge_pot_diff` with its derivative: ``gdd(d) -> (gd(d),
    gd'(d))``, ``gd'(d) = -lambdas d / sqrt(epsn + d^2)``."""

    def gdd(d: torch.Tensor):
        deno = torch.sqrt(epsn + d * d)
        return -lambdas * deno, -lambdas * d / deno

    return gdd


def make_edge_pot_truncquad(gama: float, dta: float) -> Callable:
    """Truncated-quadratic edge potential (``legacy/gqmap_cpu.m:42-44``):
    ``-(x1-x2)^2 / (2 gama)``, zero where ``|x1-x2| > dta``."""

    def f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        d = x2 - x1
        d = torch.where(d.abs() > dta, torch.zeros_like(d), d)
        return -(d * d) / (2.0 * gama)

    return f


def make_edge_pot_truncquad_diff(gama: float, dta: float) -> Callable:
    """Difference form of the truncated-quadratic edge potential."""

    def gd(d: torch.Tensor) -> torch.Tensor:
        d = torch.where(d.abs() > dta, torch.zeros_like(d), d)
        return -(d * d) / (2.0 * gama)

    return gd
