"""Middlebury flow color coding + range/unknown-mask extraction (numpy).

A copy of ``gqmap_tpu/ops/flowviz.py``: the port cannot import the JAX
package, whose ``__init__`` imports JAX.

Behavioral replacement for the reference's compiled ``flowToColor_mex``
binary (spec: ``legacy/flowToColor.m:37-87`` + ``legacy/computeColor.m``,
extended signature per ``optical_flow.m:12-13``): returns the color image,
the sanitized flow (unknown pixels zeroed), the per-channel ranges, and the
unknown mask (|u| or |v| > 1e9).

This is a host-side utility (numpy): it runs once per eval cadence on
gathered data, so there is nothing to accelerate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["FlowColorResult", "make_colorwheel", "compute_color", "flow_to_color"]

UNKNOWN_FLOW_THRESH = 1e9


class FlowColorResult(NamedTuple):
    img: np.ndarray       # (M, N, 3) uint8
    flo: np.ndarray       # (M, N, 2) sanitized flow (unknown zeroed)
    minu: float
    maxu: float
    minv: float
    maxv: float
    unknown: np.ndarray   # (M, N) bool


def make_colorwheel() -> np.ndarray:
    """55-entry RY/YG/GC/CB/BM/MR wheel (``legacy/computeColor.m:68-115``)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Angle->hue, radius->saturation coding (``legacy/computeColor.m:33-65``)."""
    u = np.asarray(u, np.float64).copy()
    v = np.asarray(v, np.float64).copy()
    nan_idx = np.isnan(u) | np.isnan(v)
    u[nan_idx] = 0.0
    v[nan_idx] = 0.0

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1) + 1.0  # [1, ncols]
    k0 = np.floor(fk).astype(np.int64)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    in_range = rad <= 1.0
    for c in range(3):
        col0 = wheel[k0 - 1, c] / 255.0
        col1 = wheel[k1 - 1, c] / 255.0
        col = (1.0 - f) * col0 + f * col1
        col = np.where(in_range, 1.0 - rad * (1.0 - col), col * 0.75)
        img[..., c] = np.floor(255.0 * col * (1.0 - nan_idx)).astype(np.uint8)
    return img


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> FlowColorResult:
    """Full ``flowToColor_mex`` behavior (``legacy/flowToColor.m:37-87``)."""
    flow = np.asarray(flow, np.float64)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("flow must be (M, N, 2)")
    u = flow[..., 0].copy()
    v = flow[..., 1].copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0.0
    v[unknown] = 0.0
    flo = np.stack([u, v], axis=-1)
    maxu = max(-999.0, float(u.max()))
    minu = min(999.0, float(u.min()))
    maxv = max(-999.0, float(v.max()))
    minv = min(999.0, float(v.min()))
    rad = np.sqrt(u * u + v * v)
    maxrad = max(-1.0, float(rad.max()))
    if max_flow is not None and max_flow > 0:
        maxrad = max_flow
    eps = np.finfo(np.float64).eps
    img = compute_color(u / (maxrad + eps), v / (maxrad + eps))
    img[unknown] = 0
    return FlowColorResult(img, flo, minu, maxu, minv, maxv, unknown)
