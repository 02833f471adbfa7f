"""Build the port's ``Problem`` and ``GQState`` from numpy arrays.

The parity tests run the JAX package and the port on identical inputs and an
identical initial state (``jax.random`` and ``torch.Generator`` give different
bits from one seed). The JAX objects cross over as numpy arrays, e.g.
``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``, so this
module needs nothing from JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import FlowRange
from .models.gqmap import GQState, Problem, _device
from .ops.chebyshev import ChebData, site_major
from .ops.cosine import CosData

__all__ = ["problem_from_numpy", "state_from_numpy"]


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def problem_from_numpy(fields: Mapping, device=None, data_term: str = "cosine") -> Problem:
    """``fields``: ``I1``, ``I2_tab``, ``interior`` (arrays), ``rng`` (four
    floats: minu, maxu, minv, maxv) and ``cheb``, a mapping of the
    coefficient field's ``coeffs``, ``lo_u``, ``hi_u``, ``lo_v``, ``hi_v``, or
    None for a Problem without a coefficient field; optionally ``init_flow``
    (an (M, N, 2) array), ``grad_tabs`` (two arrays) and ``nearest_pads`` (one
    or three arrays: ``Problem.nearest_pads``), each None or absent
    where the configuration has none. ``data_term`` says whose field ``cheb``
    is: ``CosData`` for ``"cosine"``, ``ChebData`` (stored site major, as
    ``build_cheb_data`` stores it) for ``"chebyshev"``. ``device``: the GPU
    by default (raises where there is none); a CPU run asks for ``"cpu"``."""
    device = _device(device)
    c = fields["cheb"]
    cheb = None
    if c is not None:
        coeffs = _t(c["coeffs"], device)
        if data_term == "chebyshev":
            cls, coeffs = ChebData, site_major(coeffs)
        else:
            cls = CosData
        cheb = cls(coeffs=coeffs, **{k: float(c[k]) for k in ("lo_u", "hi_u", "lo_v", "hi_v")})
    init_flow = fields.get("init_flow")
    grad_tabs = fields.get("grad_tabs")
    pads = fields.get("nearest_pads")
    return Problem(I1=_t(fields["I1"], device), I2_tab=_t(fields["I2_tab"], device),
                   interior=_t(fields["interior"], device).to(torch.bool),
                   rng=FlowRange(*(float(x) for x in fields["rng"])), cheb=cheb,
                   init_flow=None if init_flow is None else _t(init_flow, device),
                   grad_tabs=None if grad_tabs is None else tuple(_t(g, device)
                                                                  for g in grad_tabs),
                   nearest_pads=None if pads is None else tuple(_t(g, device) for g in pads))


def state_from_numpy(fields: Mapping, device=None) -> GQState:
    """``fields``: one array per ``GQState`` field; ``it`` becomes int32.
    ``device`` as in :func:`problem_from_numpy`."""
    device = _device(device)
    st = {k: _t(fields[k], device) for k in GQState._fields}
    st["it"] = st["it"].to(torch.int32)
    return GQState(**st)
