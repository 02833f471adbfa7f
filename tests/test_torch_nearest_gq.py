"""Kernels K6 and K7's module: the legacy families' nearest-lookup node quadrature.

``nearest_gq_torch`` (K6's plain version: ``gq_accumulate`` over
``make_node_pot_nearest``, or ``make_node_pot_windowed(base="nearest")`` for
a window half-size ``rg > 0``) and ``nearest_chain_gq_torch`` (K7's:
``gq_accumulate_chain`` over ``make_node_pot_nearest_chain``) are held to the
JAX package's ``gq_accumulate`` / ``gq_accumulate_chain`` over its own
potentials (the XLA scans the JAX sweep runs) in float64 at 1e-10 of each
sum's largest magnitude: rg 0, 1, 2 and 4, L = 1 and 3, K = 5, 9 and 17, rfc
2 to 4 on 12x14 to 24x28 frames whose lookups are clamped at all four
edges of the table, a shard's block (frame 1 at a pixel origin, the
window's taps across its cut), the |rho| clamp and NaN queries (the element
JAX's ``take`` reads). The CUDA kernels (``csrc/nearest_gq.cu``) run only on
the card, so their per-site loops are transcribed here in torch float64
step for step (``k6_transcribed``, ``k7_transcribed``: the point order, x_j
outer; the index arithmetic rounded op by op; each row and column cell once
a point; the NaN-keeping clamp, a NaN cell taken as 0 before the - 1 and the
64-bit flat index wrapped; frame 1's window edge-padded; the sums in the
kernel's order, the scale in the epilogue) and held to JAX at the same
tolerance, case by case and inside one ``legacy_v2``, ``legacy_v3`` and
``blockmatch_v2`` sweep each (routed in through ``pg._NODE_NEAREST`` and
``pg._NODE_CHAIN``): an algebra error shows here before any card run.

Variant ``"v2"`` of both kernels reads no table: it evaluates each looked-up
cell from the padded frame ``pad_cubic(I2)`` (K7: and the Prewitt fields'
pads) by the table's phase stencil (``ops/interp.phase_weights``). Every cell
of ``upsample_cubic``'s table is that stencil's chain of multiply-adds bit for
bit, here in float32 and float64 with an exact fused multiply-add emulated in
torch (itself checked against exact rational arithmetic), and
``k6_v2_transcribed`` / ``k7_v2_transcribed`` (the point order; a site's
shared patch of (2 rg + 4)^2 pad values where the window's cells are a
pixel apart at one phase, cell by cell elsewhere; NaN cells wrapped through
the flat index; the sums as fused multiply-adds in point order) are held to
JAX as the other versions are.
"""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqmap_tpu
import gqmap_tpu_torch
from _torch_common import assert_fields_close, port_state, shifted_pair, t
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops.gq import gq_accumulate, gq_accumulate_chain
from gqmap_tpu.ops.quadrature import build_table
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, nearest_gq
from gqmap_tpu_torch.kernels.node_gq import node_rule
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import interp
from gqmap_tpu_torch.ops.gq import GQChainRaw, GQRaw

SQRT2 = math.sqrt(2.0)
LAM, EPS = 0.3, 1e-4
KEYS = ("muu", "muv", "su", "sv", "pn")
# K6: name: (K, L, rg, rfc, frame shape, origin, local_image_shape)
CASES = {
    "nearest K=9 L=3 rfc=3": (9, 3, 0, 3, (12, 16), None, None),
    "nearest K=17 L=1 rfc=4": (17, 1, 0, 4, (12, 14), None, None),
    "window rg=2 K=9 L=1 rfc=2": (9, 1, 2, 2, (16, 20), None, None),
    "window rg=2 K=5 L=3 rfc=4": (5, 3, 2, 4, (24, 28), None, None),
    "window rg=1 K=5 L=2 rfc=3": (5, 2, 1, 3, (14, 18), None, None),
    "window rg=4 K=5 L=1 rfc=2": (5, 1, 4, 2, (16, 20), None, None),
    "shard block rg=2": (9, 2, 2, 3, (24, 28), (6, 8), (10, 12)),
    "shard block rg=0": (5, 1, 0, 2, (20, 24), (4, 12), (12, 8)),
}
# K7: name: (K, L, rfc, frame shape, origin, local_image_shape)
CHAIN_CASES = {
    "chain K=9 L=1 rfc=4": (9, 1, 4, (12, 16), None, None),
    "chain K=5 L=3 rfc=2": (5, 3, 2, (16, 20), None, None),
    "chain K=17 L=1 rfc=3": (17, 1, 3, (12, 14), None, None),
    "chain shard block": (9, 2, 3, (20, 24), (4, 8), (8, 12)),
}
VERSIONS = ["plain", "kernel transcribed", "kernel v2 transcribed"]


def _inputs(K, L, shape, local, rfc, rho=0.9, seed=0):
    """Frames (uniform noise in [0, 255], frame 2 frame 1 rolled and
    noised), the upsampled table of frame 2 and its two upsampled Prewitt
    fields (JAX's), and a state on the covered block whose means reach
    past every edge of the frame; ``st["pads"]``: the port's pads of frame 2
    and of its Prewitt fields, what "v2" reads."""
    r = np.random.default_rng(seed + 7 * K + L + rfc)
    I1 = r.uniform(0, 255, shape)
    I2 = np.roll(I1, 1, axis=1) + r.normal(0, 5, shape)
    tabs = [np.asarray(jinterp.upsample_cubic(jnp.asarray(x), rfc))
            for x in (I2, *jinterp.prewitt_gradients(jnp.asarray(I2)))]
    Ml, Nl = shape if local is None else local
    site = (L, Ml, Nl)
    st = dict(muu=r.normal(0, 3, site), muv=r.normal(0, 3, site), su=r.uniform(0.05, 3, site),
              sv=r.uniform(0.05, 3, site), pn=r.uniform(-rho, rho, site))
    st["pads"] = _pads(t(I2))
    return I1, tabs, st


def _pads(I2):
    """``Problem.nearest_pads`` of the Prewitt estimator: frame 2's pad and
    its Prewitt fields'."""
    return tuple(interp.pad_cubic(x) for x in (I2, *interp.prewitt_gradients(I2)))


def _jo(origin):
    return None if origin is None else tuple(jnp.int32(o) for o in origin)


def _jax_sums(I1, tab, st, K, rg, rfc, origin, local):
    at = dict(origin=_jo(origin), local_image_shape=local)
    if rg:
        f = jpot.make_node_pot_windowed(jnp.asarray(I1), jnp.asarray(tab), LAM, EPS, rg,
                                        "nearest", rfc, **at)
    else:
        f = jpot.make_node_pot_nearest(jnp.asarray(I1), jnp.asarray(tab), LAM, EPS, rfc, **at)
    return gq_accumulate(f, *(jnp.asarray(st[k]) for k in KEYS), build_table(K, 0, np.float64))


def _jax_chain_sums(I1, tabs, st, K, rfc, origin, local):
    fg = jpot.make_node_pot_nearest_chain(jnp.asarray(I1), *(jnp.asarray(x) for x in tabs), LAM,
                                          EPS, rfc, origin=_jo(origin), local_image_shape=local)
    return gq_accumulate_chain(fg, *(jnp.asarray(st[k]) for k in KEYS),
                               build_table(K, 0, np.float64))


def _assert_sums_match(got, want, shape):
    for name in want._fields:
        g = getattr(got, name)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape == shape, name
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
        scale = np.abs(w[~nan]).max()
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=1e-10 * scale, err_msg=name)


# ---- the kernels' arithmetic, transcribed ------------------------------------------

def _cell(pos, r, n):
    """``cell`` of ``csrc/nearest_gq.cu``: floor((pos - 1) r + 1.5) clamped
    by compare and select (NaN kept), a NaN taken as 0, then - 1."""
    v = torch.floor((pos + -1.0) * r + 1.5)
    v = torch.where(v < 1, 1.0, torch.where(v > n, float(n), v))
    return torch.where(v == v, v, 0.0).long() - 1


def _flat(ci, cj, NN, total):
    q = ci * NN + cj
    return torch.where(q < 0, q + total, q)


def _site_frame(muu, I1, origin):
    """A site's 1-based column and row coordinates and 0-based pixel rows
    and columns, and its s, t and sqrt2 sigma."""
    _, M, N = muu.shape
    r0, c0 = (0, 0) if origin is None else origin
    rows = (r0 + torch.arange(M)).reshape(M, 1)
    cols = (c0 + torch.arange(N)).reshape(1, N)
    return rows, cols, (cols + 1).to(muu.dtype), (rows + 1).to(muu.dtype)


def _whitening(su, sv, pn):
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    return (sp + sm) * 0.5, (sp - sm) * 0.5, su * SQRT2, sv * SQRT2


def k6_transcribed(I1, tab, muu, muv, su, sv, pn, K, lam, eps, rfc, rg=0, origin=None):
    """``nearest_gq_kernel`` of ``csrc/nearest_gq.cu``, one site a thread:
    frame 1's edge-padded window, then per point (x_j outer) z, x, the
    window's column cells and, row by row, its row cell and the taps'
    Charbonnier values summed into F, and the six sums of w_i w_j F; the
    scale -lam / (2 rg + 1)^2 last."""
    Mo, No = I1.shape
    MM, NN = tab.shape
    flat, total, r, W = tab.reshape(-1), MM * NN, float(1 << rfc), 2 * rg + 1
    rule = node_rule(K)
    x, w = rule[:K].tolist(), rule[K:].tolist()
    rows, cols, jj, ii = _site_frame(muu, I1, origin)
    s, tt, o1e, o2e = _whitening(su, sv, pn)
    i1w = [[I1[(rows + a - rg).clamp(0, Mo - 1), (cols + b - rg).clamp(0, No - 1)]
            for b in range(W)] for a in range(W)]
    acc = [torch.zeros_like(muu) for _ in range(6)]
    for j in range(K):
        xj, wj = x[j], w[j]
        sxj, txj, xj2 = s * xj, tt * xj, xj * xj
        for i in range(K):
            xi = x[i]
            zi = s * xi + txj
            zj = tt * xi + sxj
            x1 = o1e * zi + muu
            x2 = o2e * zj + muv
            cj = [_cell((jj + float(b - rg)) + x1, r, NN) for b in range(W)]
            F = torch.zeros_like(muu)
            for a in range(W):
                ci = _cell((ii + float(a - rg)) + x2, r, MM)
                for b in range(W):
                    d = i1w[a][b] - flat[_flat(ci, cj[b], NN, total)]
                    F = F + torch.sqrt(eps + d * d)
            fv = (w[i] * wj) * F
            xi2 = xi * xi
            for k, c in enumerate((1.0, zi, zj, xi2 + xj2 - 1.0, xi2 - xj2, xi * xj)):
                acc[k] = acc[k] + fv * c
    scale = -lam / (W * W)
    return GQRaw(*(scale * a for a in acc))


def k7_transcribed(I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, K, lam, eps, rfc, origin=None):
    """``nearest_chain_kernel`` of ``csrc/nearest_gq.cu``, one site a
    thread: per point (x_j outer) z, x, one cell, the value and both Prewitt
    fields there, the root, w (d / root), its products with the fields and
    the seven sums in gq_accumulate_chain's order; -lam and lam last."""
    MM, NN = tab.shape
    total, r = MM * NN, float(1 << rfc)
    flat, flat_u, flat_v = (x.reshape(-1) for x in (tab, tab_u, tab_v))
    rule = node_rule(K)
    x, w = rule[:K].tolist(), rule[K:].tolist()
    rows, cols, jj, ii = _site_frame(muu, I1, origin)
    s, tt, o1e, o2e = _whitening(su, sv, pn)
    i1 = I1[rows, cols]
    acc = [torch.zeros_like(muu) for _ in range(7)]
    for j in range(K):
        xj, wj = x[j], w[j]
        sxj, txj = s * xj, tt * xj
        for i in range(K):
            xi = x[i]
            zi = s * xi + txj
            zj = tt * xi + sxj
            x1 = o1e * zi + muu
            x2 = o2e * zj + muv
            q = _flat(_cell(ii + x2, r, MM), _cell(jj + x1, r, NN), NN, total)
            d = i1 - flat[q]
            deno = torch.sqrt(eps + d * d)
            wp = w[i] * wj
            wq = wp * (d / deno)
            w1, w2 = wq * flat_u[q], wq * flat_v[q]
            for k, v in enumerate((wp * deno, w1, w2, w1 * xi, w1 * xj, w2 * xi, w2 * xj)):
                acc[k] = acc[k] + v
    return GQChainRaw(-lam * acc[0], *(lam * a for a in acc[1:]))


# ---- "v2": the table's cells from the padded field ---------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """``a b`` as an unevaluated sum (Veltkamp's split, Dekker's product)."""
    def split(x):
        c = x * 134217729.0  # 2^27 + 1
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd(s, e):
    """``s + e`` (``s`` its float64 rounding to nearest) rounded to odd:
    ``s`` where ``e`` is 0 or ``s``'s last bit is 1, else ``s``'s neighbour
    toward ``e``."""
    nudge = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(nudge, torch.nextafter(s, torch.where(e > 0, math.inf, -math.inf)), s)


def fma_exact(a, b, c):
    """``a b + c`` rounded once, as ``__fma_rn`` rounds it, with no fused
    operation: float32 through the float64 product (exact) and sum rounded to
    odd (53 >= 24 + 2 bits, so the rounding to float32 is the single one);
    float64 by Boldo and Melquiond's emulation (the exact product and two
    exact sums, the low parts' sum rounded to odd)."""
    if a.dtype == torch.float32:
        p = a.double() * b.double()
        return _round_odd(*_two_sum(p, c.double())).float()
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, ul)
    vh, vl = _two_sum(uh, th)
    return vh + _round_odd(*_two_sum(tl, vl))


def _unfused(w, v, acc):
    """A chain's step with the product rounded before the sum."""
    return acc + w * v


def _table_dims(VV, rfc):
    r = 1 << rfc
    return (VV.shape[0] - 3) * r + 1, (VV.shape[1] - 3) * r + 1


def stencil_cells(VV, w, rfc, ci, cj, step=fma_exact):
    """The table's values at cells ``(ci, cj)`` (in range), each the phase
    stencil's chains of ``step`` (a fused multiply-add) over ``VV``
    (:func:`interp.phase_weights`):
    the vertical sums at the four columns, then the horizontal one; the last
    row reads ``VV[M]``, the last column the vertical sum at column ``N``."""
    M, N = VV.shape[0] - 2, VV.shape[1] - 2
    r = 1 << rfc
    MM, NN = _table_dims(VV, rfc)
    last_row, last_col = ci == MM - 1, cj == NN - 1
    iy = torch.where(last_row, 0, ci >> rfc)
    ix = torch.where(last_col, 0, cj >> rfc)
    wy, wx = w[:, ci & (r - 1)], w[:, cj & (r - 1)]

    def vert(col):
        acc = torch.zeros_like(wy[0])
        for k in range(4):
            acc = step(wy[k], VV[iy + k, col], acc)
        return torch.where(last_row, VV[M, col], acc)

    acc = torch.zeros_like(wy[0])
    for k in range(4):
        acc = step(wx[k], vert(ix + k), acc)
    return torch.where(last_col, vert(torch.full_like(cj, N)), acc)


def _v2_cells(VV, w, rfc, ci, cj, step=fma_exact):
    """``value_at`` of ``csrc/nearest_gq.cu``: a NaN query's cell (-1 on an
    axis) through the 64-bit flat index, wrapped, back to (row, column), then
    the stencil."""
    MM, NN = _table_dims(VV, rfc)
    neg = (ci < 0) | (cj < 0)
    q = _flat(ci, cj, NN, MM * NN)
    ci, cj = torch.where(neg, q // NN, ci), torch.where(neg, q % NN, cj)
    return stencil_cells(VV, w, rfc, ci, cj, step)


def _v2_window(VV, w, rfc, ci, cj, W, step=fma_exact):
    """``k6_point``'s values of the W x W window (``window_values`` on its
    shared patch where ``ci`` and ``cj`` run a pixel apart at one phase below
    the last row and column, ``value_at`` cell by cell elsewhere), as lists
    ``[a][b]``."""
    r = 1 << rfc
    MM, NN = _table_dims(VV, rfc)
    patch = (ci[0] >= 0) & (cj[0] >= 0) & (ci[-1] <= MM - 2) & (cj[-1] <= NN - 2)
    for a in range(1, W):
        patch &= (ci[a] == ci[0] + a * r) & (cj[a] == cj[0] + a * r)
    c0, d0 = torch.where(patch, ci[0], 0), torch.where(patch, cj[0], 0)
    wy, wx = w[:, c0 & (r - 1)], w[:, d0 & (r - 1)]
    iy, ix = c0 >> rfc, d0 >> rfc
    h = [[None] * W for _ in range(W)]
    for c in range(W + 3):  # a patch column: its W vertical sums, folded into the chains
        col = [VV[iy + u, ix + c] for u in range(W + 3)]
        for a in range(W):
            v = step(wy[0], col[a], torch.zeros_like(col[a]))
            for k in range(1, 4):
                v = step(wy[k], col[a + k], v)
            for b in range(max(0, c - 3), min(W, c + 1)):
                h[a][b] = step(wx[c - b], v, torch.zeros_like(v) if c == b else h[a][b])
    return [[torch.where(patch, h[a][b], _v2_cells(VV, w, rfc, ci[a], cj[b], step))
             for b in range(W)] for a in range(W)]


def _v2_points(muu, muv, su, sv, pn, K, I1, origin):
    """The K^2 points (x_j outer) as a leading axis: x_i, x_j, w_i w_j, z,
    the displacement, and the site's frame coordinates."""
    rule = torch.as_tensor(node_rule(K))
    x, wt = rule[:K], rule[K:]
    xi, xj = x.repeat(K).reshape(-1, 1, 1, 1), x.repeat_interleave(K).reshape(-1, 1, 1, 1)
    ww = wt.repeat(K).reshape(-1, 1, 1, 1) * wt.repeat_interleave(K).reshape(-1, 1, 1, 1)
    rows, cols, jj, ii = _site_frame(muu, I1, origin)
    s, tt, o1e, o2e = _whitening(su, sv, pn)
    zi = s * xi + tt * xj
    zj = tt * xi + s * xj
    return xi, xj, ww, zi, zj, o1e * zi + muu, o2e * zj + muv, rows, cols, jj, ii


def _fma(a, b, acc):
    """The kernels' sum step (``fma_``), a fused multiply-add."""
    return fma_exact(*torch.broadcast_tensors(a, b, acc))


def k6_v2_transcribed(I1, tab, muu, muv, su, sv, pn, K, lam, eps, rfc, rg=0, origin=None,
                      pads=None):
    """``nearest_gq_v2_kernel`` of ``csrc/nearest_gq.cu``: per point (x_j
    outer) z, x, the window's row and column cells and their values from
    ``pads[0]`` (the compiled window sizes, rg 0 and 2, through
    :func:`_v2_window`; the others cell by cell), F over the taps in v1's
    order, and the six sums as fused multiply-adds of w_i w_j F in point
    order, the scale last. ``tab`` is not read."""
    VV = pads[0]
    w = interp.phase_weights(rfc, VV.dtype, VV.device)
    MM, NN = _table_dims(VV, rfc)
    Mo, No = I1.shape
    r, W = float(1 << rfc), 2 * rg + 1
    xi, xj, ww, zi, zj, x1, x2, rows, cols, jj, ii = _v2_points(muu, muv, su, sv, pn, K, I1,
                                                                origin)
    ci = [_cell((ii + float(a - rg)) + x2, r, MM) for a in range(W)]
    cj = [_cell((jj + float(b - rg)) + x1, r, NN) for b in range(W)]
    if rg in (0, 2):
        vals = _v2_window(VV, w, rfc, ci, cj, W)
    else:
        vals = [[_v2_cells(VV, w, rfc, ci[a], cj[b]) for b in range(W)] for a in range(W)]
    F = torch.zeros_like(x1)
    for a in range(W):
        for b in range(W):
            i1 = I1[(rows + a - rg).clamp(0, Mo - 1), (cols + b - rg).clamp(0, No - 1)]
            d = i1 - vals[a][b]
            F = F + torch.sqrt(_fma(d, d, torch.tensor(eps, dtype=d.dtype)))
    fv = ww * F
    xi2, xj2 = xi * xi, xj * xj
    coef = (torch.ones_like(zi), zi, zj, (xi2 + xj2) + -1.0, xi2 - xj2, xi * xj)
    acc = [torch.zeros_like(muu) for _ in range(6)]
    for p in range(K * K):
        for k, c in enumerate(coef):
            acc[k] = _fma(fv[p], c[p], acc[k])
    scale = -lam / (W * W)
    return GQRaw(*(scale * a for a in acc))


def k7_v2_transcribed(I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, K, lam, eps, rfc,
                      origin=None, pads=None):
    """``nearest_chain_v2_kernel``: per point one cell, the three fields'
    values there from ``pads`` (the 4 x 4 patch below the last row and
    column, ``value_at`` elsewhere), the root, w (d / root), w1 and w2, and
    the seven sums as fused multiply-adds in point order (``sum7``); -lam
    and lam last. The tables are not read."""
    w = interp.phase_weights(rfc, pads[0].dtype, pads[0].device)
    MM, NN = _table_dims(pads[0], rfc)
    r = float(1 << rfc)
    xi, xj, ww, zi, zj, x1, x2, rows, cols, jj, ii = _v2_points(muu, muv, su, sv, pn, K, I1,
                                                                origin)
    ci, cj = [_cell(ii + x2, r, MM)], [_cell(jj + x1, r, NN)]
    v, vu, vv = (_v2_window(VV, w, rfc, ci, cj, 1)[0][0] for VV in pads[:3])
    d = I1[rows, cols] - v
    deno = torch.sqrt(_fma(d, d, torch.tensor(eps, dtype=d.dtype)))
    wq = ww * (d / deno)
    w1, w2 = wq * vu, wq * vv
    one = torch.ones_like(w1)
    terms = ((ww, deno), (w1, one), (w2, one), (w1, xi), (w1, xj), (w2, xi), (w2, xj))
    acc = [torch.zeros_like(muu) for _ in range(7)]
    for p in range(K * K):
        for k, (A, B) in enumerate(terms):
            acc[k] = _fma(A[p], B[p], acc[k])
    return GQChainRaw(-lam * acc[0], *(lam * a for a in acc[1:]))


def _k6(version, I1, tab, st, K, rg, rfc, origin, local):
    args = (t(I1), t(tab), *(t(st[k]) for k in KEYS), K, LAM, EPS, rfc)
    if version == "plain":
        return nearest_gq.nearest_gq_torch(*args, rg=rg, origin=origin, local_image_shape=local,
                                           quad_chunk=K)
    if version == "kernel v2 transcribed":
        return k6_v2_transcribed(*args, rg=rg, origin=origin, pads=st["pads"])
    return k6_transcribed(*args, rg=rg, origin=origin)


def _k7(version, I1, tabs, st, K, rfc, origin, local):
    args = (t(I1), *(t(x) for x in tabs), *(t(st[k]) for k in KEYS), K, LAM, EPS, rfc)
    if version == "plain":
        return nearest_gq.nearest_chain_gq_torch(*args, origin=origin, local_image_shape=local,
                                                 quad_chunk=K)
    if version == "kernel v2 transcribed":
        return k7_v2_transcribed(*args, origin=origin, pads=st["pads"])
    return k7_transcribed(*args, origin=origin)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("case", list(CASES))
def test_nearest_sums_match_jax(case, version):
    K, L, rg, rfc, shape, origin, local = CASES[case]
    I1, tabs, st = _inputs(K, L, shape, local, rfc)
    want = _jax_sums(I1, tabs[0], st, K, rg, rfc, origin, local)
    got = _k6(version, I1, tabs[0], st, K, rg, rfc, origin, local)
    _assert_sums_match(got, want, st["muu"].shape)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_sums_match_jax(case, version):
    K, L, rfc, shape, origin, local = CHAIN_CASES[case]
    I1, tabs, st = _inputs(K, L, shape, local, rfc)
    want = _jax_chain_sums(I1, tabs, st, K, rfc, origin, local)
    got = _k7(version, I1, tabs, st, K, rfc, origin, local)
    _assert_sums_match(got, want, st["muu"].shape)


def _raw_cells(I1, tab, st, K, rfc, rg=0, origin=None):
    """Every unclamped cell (floor((pos - 1) r + 1.5)) of a state's lookups,
    rows and columns, as numpy arrays."""
    rule = node_rule(K)
    x = rule[:K]
    xi, xj = np.tile(x, K), np.repeat(x, K)
    p = st["pn"][..., None]
    sp, sm = np.sqrt(1 + p), np.sqrt(1 - p)
    s, tt = (sp + sm) / 2, (sp - sm) / 2
    _, M, N = st["muu"].shape
    r0, c0 = (0, 0) if origin is None else origin
    X = (c0 + np.arange(N)[:, None] + 1 + st["muu"][..., None]
         + SQRT2 * st["su"][..., None] * (s * xi + tt * xj))
    Y = (r0 + np.arange(M)[:, None, None] + 1 + st["muv"][..., None]
         + SQRT2 * st["sv"][..., None] * (tt * xi + s * xj))
    r = 1 << rfc
    return (np.floor((np.concatenate([Y - rg, Y + rg]) - 1) * r + 1.5),
            np.floor((np.concatenate([X - rg, X + rg]) - 1) * r + 1.5))


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if v[5] is None])
def test_cases_clamp_at_every_table_edge(case):
    # each whole-frame case's lookups leave the table on all four sides, so
    # the clamp (both bounds of both axes) is part of every comparison above
    K, L, rg, rfc, shape, origin, local = CASES[case]
    I1, tabs, st = _inputs(K, L, shape, local, rfc)
    rows, cols = _raw_cells(I1, tabs[0], st, K, rfc, rg, origin)
    MM, NN = tabs[0].shape
    assert (rows < 1).any() and (rows > MM).any() and (cols < 1).any() and (cols > NN).any()
    inside = (rows >= 1) & (rows <= MM)
    assert inside.mean() > 0.3


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("kind", ["nearest", "window rg=2", "chain"])
def test_sums_at_the_rho_clamp_match_jax(kind, version):
    # |rho| = 1 - 1e-5, the corr_tor corner: t ~ s, the whitened points
    # collapse onto the diagonal
    K, L, shape, rfc, rg = 9, 2, (12, 16), 3, 2 if kind == "window rg=2" else 0
    I1, tabs, st = _inputs(K, L, shape, None, rfc)
    st["pn"] = 0.99999 * np.sign(st["pn"])
    if kind == "chain":
        want = _jax_chain_sums(I1, tabs, st, K, rfc, None, None)
        got = _k7(version, I1, tabs, st, K, rfc, None, None)
    else:
        want = _jax_sums(I1, tabs[0], st, K, rg, rfc, None, None)
        got = _k6(version, I1, tabs[0], st, K, rg, rfc, None, None)
    _assert_sums_match(got, want, st["muu"].shape)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("kind", ["nearest", "window rg=2", "chain"])
@pytest.mark.parametrize("field", ["muu", "muv", "su", "pn"])
def test_nan_query_reads_what_jax_reads(field, kind, version):
    # a NaN mean, sigma or correlation at one site: its axis cell is -1 (XLA
    # converts a NaN index to 0 before the clamp's - 1) and the flat index
    # wraps, so the lookup reads the element JAX's take reads there; the
    # sums are NaN only where a NaN weight (z, from a NaN correlation) enters
    K, L, shape, rfc, rg = 5, 2, (12, 16), 3, 2 if kind == "window rg=2" else 0
    I1, tabs, st = _inputs(K, L, shape, None, rfc, seed=3)
    st[field][1, 0, 0] = np.nan
    st[field][0, 5, 7] = np.nan
    if kind == "chain":
        want = _jax_chain_sums(I1, tabs, st, K, rfc, None, None)
        got = _k7(version, I1, tabs, st, K, rfc, None, None)
    else:
        want = _jax_sums(I1, tabs[0], st, K, rg, rfc, None, None)
        got = _k6(version, I1, tabs[0], st, K, rg, rfc, None, None)
    nan_sums = {k for k, v in want._asdict().items() if np.isnan(np.asarray(v)).any()}
    assert nan_sums == ({"Z1", "Z2"} if field == "pn" and kind != "chain" else set())
    _assert_sums_match(got, want, st["muu"].shape)


# ---- the sweeps, with the transcriptions routed in ---------------------------------

FR = (-2.0, 2.0, -2.0, 2.0)
FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
SWEEPS = {  # name: (preset, frame, overrides)
    "legacy_v2": ("legacy_v2", (24, 28), dict(K=5)),
    "legacy_v3": ("legacy_v3", (24, 28), dict(K=5)),
    "blockmatch_v2": ("blockmatch_v2", (12, 14), {}),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_preset_sweep_through_the_transcribed_kernels_matches_jax(name, monkeypatch):
    # the route make_sweep takes for "auto" (K6 on legacy_v2's windowed and
    # blockmatch_v2's K = 17 lookups, K7 on legacy_v3's chain), here the
    # kernels' transcriptions: one sweep of each against JAX's
    preset, shape, kw = SWEEPS[name]
    calls = []

    def route(fn):
        def run(*args, quad_chunk=0, local_image_shape=None, pads=None, **at):
            calls.append(fn.__name__)
            return fn(*args, **at)
        return run

    monkeypatch.setitem(pg._NODE_NEAREST, "auto", route(k6_transcribed))
    monkeypatch.setitem(pg._NODE_CHAIN, "auto", route(k7_transcribed))
    cfg = dict(dtype="float64", its=2, eval_every=2, **kw)
    jc = getattr(gqmap_tpu.GQMAPConfig, preset)(**cfg)
    pc = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**cfg)
    I1, I2, _ = shifted_pair(*shape)
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    pp = problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab), interior=np.asarray(jp.interior),
        rng=tuple(jp.rng), cheb=None,
        grad_tabs=None if jp.grad_tabs is None else [np.asarray(g) for g in jp.grad_tabs]),
        device="cpu")
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), shape)
    j1, jaux = jax.jit(jg.make_sweep(jc, shape))(jp, js)
    p1, paux = pg.make_sweep(pc, shape)(pp, port_state(js))
    assert calls == ["k7_transcribed" if preset == "legacy_v3" else "k6_transcribed"]
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_preset_sweep_through_the_v2_transcriptions_matches_jax(name, monkeypatch):
    # as above with "v2"'s transcriptions, which read Problem.nearest_pads
    # (given to problem_from_numpy as the port builds them) and no table
    preset, shape, kw = SWEEPS[name]
    calls = []

    def route(fn):
        def run(*args, quad_chunk=0, local_image_shape=None, **at):
            calls.append(fn.__name__)
            return fn(*args, **at)
        return run

    monkeypatch.setitem(pg._NODE_NEAREST, "auto", route(k6_v2_transcribed))
    monkeypatch.setitem(pg._NODE_CHAIN, "auto", route(k7_v2_transcribed))
    cfg = dict(dtype="float64", its=2, eval_every=2, **kw)
    jc = getattr(gqmap_tpu.GQMAPConfig, preset)(**cfg)
    pc = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**cfg)
    I1, I2, _ = shifted_pair(*shape)
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    own = pg.make_problem(pc, I1, I2, gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    pp = problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab), interior=np.asarray(jp.interior),
        rng=tuple(jp.rng), cheb=None,
        grad_tabs=None if jp.grad_tabs is None else [np.asarray(g) for g in jp.grad_tabs],
        nearest_pads=[x.numpy() for x in own.nearest_pads]), device="cpu")
    assert len(pp.nearest_pads) == (3 if preset == "legacy_v3" else 1)
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), shape)
    j1, jaux = jax.jit(jg.make_sweep(jc, shape))(jp, js)
    p1, paux = pg.make_sweep(pc, shape)(pp, port_state(js))
    assert calls == ["k7_v2_transcribed" if preset == "legacy_v3" else "k6_v2_transcribed"]
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


# ---- "v2"'s stencil against the table ------------------------------------------------

def test_fma_exact_rounds_once():
    # against exact rational arithmetic (Python's float of a Fraction rounds
    # correctly; float32 by its two neighbours), on random triples and on
    # c = -(a b) rounded, where a separate product and sum lose everything
    g = np.random.default_rng(11)
    for dtype in (torch.float64, torch.float32):
        a, b, c = (torch.as_tensor(g.uniform(-1, 1, 400) * s, dtype=dtype) for s in (300, 1, 300))
        c[:200] = -(a[:200] * b[:200])
        got = fma_exact(a, b, c)
        for x, y, z, f in zip(a.tolist(), b.tolist(), c.tolist(), got.tolist()):
            exact = Fraction(x) * Fraction(y) + Fraction(z)
            if dtype == torch.float64:
                assert f == float(exact)
            else:
                near = np.float32(float(exact))
                cands = [np.nextafter(near, np.float32(d)) for d in (-np.inf, np.inf)] + [near]
                best = min(abs(Fraction(float(v)) - exact) for v in cands)
                err = abs(Fraction(f) - exact)
                assert err == best and (err != 0 or f == float(exact))
        assert not torch.equal(got, c + a * b)  # the separate rounding differs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape, rfc", [((12, 14), 2), ((16, 20), 3), ((24, 28), 4)])
def test_stencil_equals_the_table_at_every_cell(shape, rfc, dtype):
    # every cell of upsample_cubic's table, the last row and column
    # included, is the phase stencil's chain of fused multiply-adds (each
    # addcmul_ step rounded once), bit for bit; with the product rounded
    # before the sum cells miss; and the cells NaN queries reach (a -1 on
    # either axis, through the wrapped flat index) are the table's elements
    # there
    V = torch.as_tensor(np.random.default_rng(rfc).uniform(0, 255, shape), dtype=dtype)
    tab = interp.upsample_cubic(V, rfc)
    VV, w = interp.pad_cubic(V), interp.phase_weights(rfc, dtype, "cpu")
    MM, NN = tab.shape
    assert _table_dims(VV, rfc) == (MM, NN)
    ci, cj = (x.reshape(-1) for x in torch.meshgrid(torch.arange(MM), torch.arange(NN),
                                                    indexing="ij"))
    assert torch.equal(stencil_cells(VV, w, rfc, ci, cj), tab.reshape(-1))
    missed = stencil_cells(VV, w, rfc, ci, cj, _unfused) != tab.reshape(-1)
    assert missed.double().mean() > 0.05
    ni = torch.tensor([-1, -1, -1, 0, 5, MM - 1, -1])
    nj = torch.tensor([0, 7, -1, -1, -1, -1, NN - 1])
    flat = tab.reshape(-1)[_flat(ni, nj, NN, MM * NN)]
    assert torch.equal(_v2_cells(VV, w, rfc, ni, nj), flat)


def test_phase_weights_are_the_tables():
    # upsample_cubic weighs its taps with phase_weights: a table built from
    # an impulse reads the weights back (rows of the (4, r) array, halved
    # twice: once a pass)
    rfc, r = 3, 8
    V = torch.zeros((8, 8), dtype=torch.float64)
    V[4, 4] = 1.0
    w = interp.phase_weights(rfc, torch.float64, "cpu")
    assert w.shape == (4, r)
    torch.testing.assert_close(w.sum(0), torch.ones(r, dtype=torch.float64), rtol=0, atol=1e-15)
    tab = interp.upsample_cubic(V, rfc)
    # cell (3 r + py, 3 r + px) has base pixel (3, 3) (pads row 4 = pixel 3) and
    # reads the impulse (pixel 4, pad 5) as tap 2 on both axes
    for py in range(r):
        for px in range(r):
            assert tab[3 * r + py, 3 * r + px] == w[2, py] * w[2, px]


# ---- routing, wrappers and the sector count ------------------------------------------

@pytest.mark.parametrize("preset, kw, want", [
    ("legacy_v2", {}, "K6"), ("blockmatch_v2", {}, "K6"), ("legacy_v3", {}, "K7"),
    ("full_mixture", dict(data_term="nearest"), "K6"),
    ("full_mixture", dict(data_term="nearest", window_rg=1), "K6"),
    ("legacy_v2", dict(window_rg=0), "K6"), ("legacy_v3", dict(window_rg=2), "K7"),
    # the windowed bicubic term is K12's up to a radius of 4, plain beyond it
    ("full_mixture", dict(data_term="bicubic", window_rg=5), None),
])
def test_node_kernel_names_k6_and_k7(preset, kw, want):
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw)
    assert pg._node_kernel(cfg) == want
    for route in ("auto", "torch") + (("cuda",) if want else ()):
        pg.check_supported(getattr(gqmap_tpu_torch.GQMAPConfig, preset)(node_kernel=route, **kw))


@pytest.mark.parametrize("preset", ["legacy_v2", "blockmatch_v2", "legacy_v3"])
def test_cuda_route_under_autodiff_raises(preset):
    # under autodiff K6 computes the nearest lookup's value (its gradient is
    # zero: the index is a floor), so "cuda" runs there; the windowed
    # Chebyshev term of the same presets no kernel computes under autodiff
    # (the windowed bicubic term runs K16 since it was ported): "cuda" raises
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)
    assert pg._node_kernel(cfg(gradient_estimator="autodiff")) == "K6"
    pg.check_supported(cfg(node_kernel="cuda", gradient_estimator="autodiff"))
    with pytest.raises(ValueError, match="kernel K6.*kernel K7"):
        pg.check_supported(cfg(node_kernel="cuda", gradient_estimator="autodiff",
                               data_term="chebyshev", window_rg=2))
    pg.check_supported(cfg(node_kernel="auto", gradient_estimator="autodiff"))


def test_wrappers_run_plain_versions_on_cpu_and_launch_nothing():
    K, L, rg, rfc, shape, _, _ = CASES["window rg=2 K=9 L=1 rfc=2"]
    I1, tabs, st = _inputs(K, L, shape, None, rfc)
    sites = [t(st[k]) for k in KEYS]
    args = (t(I1), t(tabs[0]), *sites, K, LAM, EPS, rfc, rg)
    for g, w in zip(nearest_gq.nearest_gq(*args), nearest_gq.nearest_gq_torch(*args)):
        assert torch.equal(g, w)
    cargs = (t(I1), *(t(x) for x in tabs), *sites, K, LAM, EPS, rfc)
    for g, w in zip(nearest_gq.nearest_chain_gq(*cargs),
                    nearest_gq.nearest_chain_gq_torch(*cargs)):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="nearest_gq_cuda needs CUDA"):
        nearest_gq.nearest_gq_cuda(*args)
    with pytest.raises(RuntimeError, match="nearest_chain_gq_cuda needs CUDA"):
        nearest_gq.nearest_chain_gq_cuda(*cargs)
    assert nearest_gq.nearest_gq_cuda.launches == nearest_gq.nearest_chain_gq_cuda.launches == 0
    assert nearest_gq.nearest_gq_cuda in COUNTED and nearest_gq.nearest_chain_gq_cuda in COUNTED


@pytest.mark.parametrize("preset, wrapper", [("legacy_v2", "nearest_gq_cuda"),
                                             ("blockmatch_v2", "nearest_gq_cuda"),
                                             ("legacy_v3", "nearest_chain_gq_cuda")])
def test_cpu_sweep_routes_the_lookup_through_its_kernel(preset, wrapper):
    # "cuda" sends the node term to K6 or K7, which refuse CPU tensors rather
    # than fall back; "auto" runs their plain versions there, bit for bit
    # "torch"'s
    C = getattr(gqmap_tpu_torch.GQMAPConfig, preset)
    kw = dict(K=5, dtype="float64", edge_kernel="torch")
    I1, I2, _ = shifted_pair(16, 20)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    cfg = C(**kw)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    state = pg.init_state(cfg, fr, I1.shape, device="cpu")
    before = [k.launches for k in COUNTED]
    with pytest.raises(RuntimeError, match=f"{wrapper} needs CUDA"):
        pg.make_sweep(C(node_kernel="cuda", **kw), I1.shape)(problem, state)
    a, aux_a = pg.make_sweep(cfg, I1.shape)(problem, state)
    b, aux_b = pg.make_sweep(C(node_kernel="torch", **kw), I1.shape)(problem, state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(aux_a, aux_b))
    assert [k.launches for k in COUNTED] == before == [0] * len(COUNTED)


def test_every_macro_entry_point_has_its_ctypes_signature():
    # each C entry point a csrc macro makes (GQMAP_X(name, type)) is declared
    # in build._SIGNATURES with its parameters' count and kinds (a pointer,
    # an int or a double each), so ctypes passes every argument at its width
    import glob
    import os
    import re

    from gqmap_tpu_torch.kernels import build

    kinds = {"void*": build._P, "int": build._I, "double": build._D}
    seen = 0
    for path in glob.glob(os.path.join(build.CSRC, "*.cu")):
        text = open(path).read()
        macros = {}
        for m in re.finditer(r'#define (GQMAP_\w+)\(NAME, T\)\s*\\\s*extern "C" int NAME\((.*?)\)',
                             text, re.S):
            params = [re.sub(r"[\\\s]+", " ", x).strip() for x in m.group(2).split(",")]
            macros[m.group(1)] = [kinds[re.sub(r"^const |\s*\w+$", "", x).replace(" ", "")]
                                  for x in params]
        for m in re.finditer(r"^(GQMAP_\w+)\((gqmap_\w+), \w+\)$", text, re.M):
            assert build._SIGNATURES[m.group(2)] == macros[m.group(1)], m.group(2)
            seen += 1
    assert seen >= 16


@pytest.mark.parametrize("variant, K, rfc, want", [
    (None, 9, 6, "v2"), (None, 17, 6, "v2"), (None, 24, 8, "v2"), (None, 25, 6, "v1"),
    (None, 9, 9, "v1"), ("v1", 9, 6, "v1"), ("v2", 24, 8, "v2"), ("v2", 25, 6, ValueError),
    ("v2", 9, 9, ValueError), ("v3", 9, 6, ValueError)])
def test_resolve_variant(variant, K, rfc, want):
    # "v2" by default where its tables fit (K <= 24, rfc <= 8), "v1"
    # elsewhere; an explicit "v2" outside that, or an unknown name, raises
    if want is ValueError:
        with pytest.raises(ValueError):
            nearest_gq.resolve_variant(variant, K, rfc)
    else:
        assert nearest_gq.resolve_variant(variant, K, rfc) == want


@pytest.mark.parametrize("preset, kw, n", [("legacy_v2", {}, 1), ("blockmatch_v2", {}, 1),
                                           ("legacy_v3", {}, 3),
                                           ("full_mixture", dict(data_term="nearest"), 1),
                                           ("tpu_fast", {}, 0), ("full_mixture", {}, 0)])
def test_problem_carries_the_pads(preset, kw, n):
    # make_problem keeps pad_cubic of frame 2 (and of its Prewitt fields) for
    # the nearest lookup, None elsewhere; the sharded spec replicates them
    from gqmap_tpu_torch.parallel.sharded import problem_sharding

    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw)
    I1, I2, _ = shifted_pair(16, 20)
    p = pg.make_problem(cfg, I1, I2, gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    if n == 0:
        assert p.nearest_pads is None
        return
    want = _pads(torch.as_tensor(I2, dtype=p.I1.dtype))[:n]
    assert len(p.nearest_pads) == n
    assert all(torch.equal(a, b) for a, b in zip(p.nearest_pads, want))
    assert problem_sharding().nearest_pads == ()


@pytest.mark.parametrize("rg, origin", [(0, None), (2, None), (2, (3, 5))])
def test_lookup_sectors_counts_the_distinct_sectors(rg, origin):
    # against the transcription's own cells: each (point, tap) one lookup,
    # the sectors the set of flat index * 8 bytes // 32 (float64: 4 a sector)
    K, L, rfc, shape = 5, 2, 3, (12, 16)
    local = None if origin is None else (6, 8)
    I1, tabs, st = _inputs(K, L, shape, local, rfc)
    tab = t(tabs[0])
    MM, NN = tab.shape
    seen = set()
    rule = node_rule(K)
    x = rule[:K].tolist()
    s, tt, o1e, o2e = _whitening(t(st["su"]), t(st["sv"]), t(st["pn"]))
    _, _, jj, ii = _site_frame(t(st["muu"]), t(I1), origin)
    for xj in x:
        for xi in x:
            x1 = o1e * (s * xi + tt * xj) + t(st["muu"])
            x2 = o2e * (tt * xi + s * xj) + t(st["muv"])
            for a in range(-rg, rg + 1):
                ci = _cell((ii + float(a)) + x2, float(1 << rfc), MM)
                for b in range(-rg, rg + 1):
                    cj = _cell((jj + float(b)) + x1, float(1 << rfc), NN)
                    seen.update((_flat(ci, cj, NN, MM * NN) // 4).reshape(-1).tolist())
    lookups, sectors = nearest_gq.lookup_sectors(tab, *(t(st[k]) for k in KEYS), K, rfc, rg,
                                                 origin)
    assert lookups == L * math.prod(st["muu"].shape[1:]) * K * K * (2 * rg + 1) ** 2
    assert sectors == len(seen)
