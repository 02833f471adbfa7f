"""MRF potentials of the main path (port of ``gqmap_tpu/ops/potentials.py``).

Node (data) potential: Charbonnier brightness constancy against a bicubically
sampled second frame (``gqmap_gpu_mixture.m:156-179``): the exact path's node
term (through :func:`gqmap_tpu_torch.ops.gq.gq_accumulate`) and the logP
readout. Edge (smoothness) potential: Charbonnier on the neighbour flow
difference (``:180-182``), in its two-endpoint and difference forms.
"""

from __future__ import annotations

from typing import Callable

import torch

from .interp import sample_bicubic

__all__ = ["make_node_pot_bicubic", "make_edge_pot", "make_edge_pot_diff"]


def make_node_pot_bicubic(I1: torch.Tensor, VV: torch.Tensor, lambdad: float,
                          epsn: float, patch: int = 1) -> Callable:
    """Return ``f(x1, x2) -> node potential`` over the ``(Mo, No)`` lattice.

    ``VV = pad_cubic(I2)``; ``x1``/``x2`` are displacements of shape
    ``lead + (M, N)``, ``lead`` any leading broadcast axes (quadrature
    chunk, mixture component), on the flow lattice ``(M, N) = (Mo, No) /
    patch``. For ``patch > 1`` each flow node sums the potential over its
    ``patch x patch`` pixel block (super lattice): the displacements are
    repeated to full resolution, sampled, and summed back per block.
    """
    Mo, No = I1.shape
    jj = 1.0 + torch.arange(No, dtype=I1.dtype, device=I1.device).reshape(1, No)
    ii = 1.0 + torch.arange(Mo, dtype=I1.dtype, device=I1.device).reshape(Mo, 1)

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
