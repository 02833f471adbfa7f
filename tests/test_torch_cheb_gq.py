"""Kernel K5's module: the Chebyshev data term's node quadrature.

``cheb_gq_torch`` (the plain version, ``gq_accumulate`` over
``make_node_pot_chebyshev``) is held to the JAX package's ``gq_accumulate``
over its ``make_node_pot_chebyshev`` (the XLA scan the JAX sweep runs) on
the JAX package's own coefficient field, in float64 at 1e-10 of each sum's
largest magnitude: K = 5 and 9, L = 3, (P, Q) = (12, 8) and (16, 6), at
patch 1 and 4 and with ``window_rg = 2``, on states whose samples leave the
displacement box on both sides of both axes (the clip acts), at the |rho|
clamp and with NaN queries (NaN where JAX gives NaN). The CUDA kernel
(``csrc/cheb_gq.cu``) runs only on the card, so its per-site arithmetic is
transcribed here in torch float64 step for step (the sample order j = l K^2
+ p, the whitening, the NaN-keeping clip, the v-basis padded with zero
columns to the instance's width, the u-degree walk with T_{-1} = T_1, each
row's contraction over b >= 1 from its highest column down, column 0 summed
apart and C[0, 0] added last, and the reduction: 32 lanes over a
component's points and their xor tree) and held to JAX at the same
tolerance: an algebra error shows here before any card run. So is variant
"v2"'s (``k5_v2_transcribed``: the tensor cores' 3xTF32 split by integer
masking, one accumulator, the stride-8 u-chains, column 0 and C[0, 0] apart,
the quad's xor tree), at float64's width of the split against JAX and at
TF32's against the f64 golden under the card's ratio rule, where one TF32
product fails it. One
``full_mixture`` and one ``tpu_fast`` Chebyshev sweep with the
transcription in the kernel's place are held to JAX's sweeps as the plain
route is (``tests/test_torch_chebyshev.py``), and so are sweeps through the
v2 transcription. Then the routing (``"K5"`` under the Stein estimator,
refused under autodiff and past 64 v-degrees, no launch on the CPU), the
variant rule and v2's layout, and ``k5_work``'s counts.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqmap_tpu
import gqmap_tpu_torch
from _torch_common import assert_fields_close, np_fields, port_state, shifted_pair, t
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import chebyshev as jcheb
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops.gq import gq_accumulate
from gqmap_tpu.ops.quadrature import build_table
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, cheb_gq, roofline
from gqmap_tpu_torch.kernels.node_gq import node_rule
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops.chebyshev import ChebData, site_major
from gqmap_tpu_torch.ops.gq import GQRaw

SQRT2 = math.sqrt(2.0)
SHAPE = (20, 24)
BOX = (-3.0, 2.5, -1.5, 1.5)
# name: (K, P, Q, patch, window_rg)
CASES = {
    "K=9 12x8 patch 1": (9, 12, 8, 1, 0),
    "K=5 16x6 patch 1": (5, 16, 6, 1, 0),
    "K=9 16x6 patch 4": (9, 16, 6, 4, 0),
    "K=5 12x8 patch 4": (5, 12, 8, 4, 0),
    "K=9 12x8 window_rg 2": (9, 12, 8, 1, 2),
    "K=5 16x6 window_rg 2": (5, 16, 6, 1, 2),
}
VERSIONS = ["plain", "kernel transcribed", "v2 transcribed"]


def _field(P, Q, patch, window_rg, seed=0):
    """The JAX package's coefficient field of a shifted pair and the port's
    record of the same values, stored site major."""
    I1, I2, _ = shifted_pair(*SHAPE, seed=seed)
    VV = jinterp.pad_cubic(jnp.asarray(I2))
    jc = jcheb.build_cheb_data(jnp.asarray(I1), VV, 1.0, 1e-6, BOX, P=P, Q=Q, patch=patch,
                               window_rg=window_rg)
    return jc, ChebData(site_major(t(jc.coeffs)), *BOX)


def _state(L, M, N, seed=0, rho=0.9):
    """Means around 0 and sigmas up to 2 px (u) and 1 px (v): about 40% of
    the samples inside the box, the others past each of its edges."""
    r = np.random.default_rng(seed + 11 * M + N)
    site = (L, M, N)
    return dict(muu=r.normal(0, 1.5, site), muv=r.normal(0, 0.75, site),
                su=r.uniform(0.05, 2, site), sv=r.uniform(0.05, 1, site),
                pn=r.uniform(-rho, rho, site))


def _jax_sums(jc, st, K):
    return gq_accumulate(jcheb.make_node_pot_chebyshev(jc),
                         *(jnp.asarray(st[k]) for k in ("muu", "muv", "su", "sv", "pn")),
                         build_table(K, 0, np.float64))


def _port(st):
    return tuple(t(st[k]) for k in ("muu", "muv", "su", "sv", "pn"))


def _assert_sums_match(got, want, shape):
    for name in GQRaw._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape == shape, name
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
        scale = np.abs(w[~nan]).max()
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=1e-10 * scale, err_msg=name)


# ---- the kernel's arithmetic, transcribed -------------------------------------------

def _clip(x):
    """The kernel's clip: compare and select, a NaN kept."""
    return torch.where(x < -1, -1.0, torch.where(x > 1, 1.0, x))


def _samples(cheb, muu, muv, su, sv, pn, K):
    """Both kernels' samples in the box: (u', v') of each sample j = l K^2 +
    p (p = jx K + ix) of each site, as ``(L K^2, S)`` tensors in the state's
    type, the clip a compare and select."""
    dt = muu.dtype
    P, Q, M, N = cheb.coeffs.shape
    L, S, K2 = muu.shape[0], M * N, K * K
    x = node_rule(K)[:K]
    p = np.tile(np.arange(K2), L)
    comp = np.repeat(np.arange(L), K2)
    xi, xj = (t(x[i]).to(dt).reshape(-1, 1) for i in (p % K, p // K))
    u1, u2, o1, o2, rho = (f.reshape(L, S)[comp] for f in (muu, muv, su, sv, pn))  # (NS, S)
    sp, sm = torch.sqrt(1.0 + rho), torch.sqrt(1.0 - rho)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    zi, zj = s * xi + tt * xj, tt * xi + s * xj
    x1, x2 = o1 * SQRT2 * zi + u1, o2 * SQRT2 * zj + u2
    cu, ru = (cheb.lo_u + cheb.hi_u) * 0.5, (cheb.hi_u - cheb.lo_u) * 0.5
    cv, rv = (cheb.lo_v + cheb.hi_v) * 0.5, (cheb.hi_v - cheb.lo_v) * 0.5
    return _clip((x1 - cu) / ru), _clip((x2 - cv) / rv)


def _six_sums(f, pn, K):
    """The kernels' reduction of the series values ``f`` ``(L, K^2, S)``:
    for each component 32 lanes, lane k over the points k, k + 32, ..., the
    six sums on w_i w_j f, the xor tree, lane 0's values."""
    L, K2, S = f.shape
    rule = node_rule(K)
    x, w = rule[:K], rule[K:]
    out = []
    for comp_l in range(L):
        lanes = []
        for k in range(32):
            sums = [torch.zeros(S, dtype=f.dtype) for _ in range(6)]
            for q in range(k, K2, 32):
                ix, jx = q % K, q // K
                fv = (w[ix] * w[jx]) * f[comp_l, q]
                for n, c in enumerate((1.0, x[ix], x[jx], x[ix] * x[jx],
                                       x[ix] * x[ix] + x[jx] * x[jx] - 1.0,
                                       x[ix] * x[ix] - x[jx] * x[jx])):
                    sums[n] = sums[n] + (fv if n == 0 else c * fv)
            lanes.append(sums)
        for off in (16, 8, 4, 2, 1):
            lanes = [[a + b for a, b in zip(lanes[k], lanes[k ^ off])] for k in range(32)]
        out.append(lanes[0])
    M, N = pn.shape[1:]
    e, sxi, sxj, sxixj, sx2a, sx2m = (torch.stack([o[n] for o in out]).reshape(L, M, N)
                                      for n in range(6))
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    return GQRaw(e, s * sxi + tt * sxj, tt * sxi + s * sxj, sx2a, sx2m, sxixj)


def k5_transcribed(cheb, muu, muv, su, sv, pn, K, quad_chunk=0):
    """``cheb_gq_kernel`` of ``csrc/cheb_gq.cu`` at every site at once: the
    samples j = l K^2 + p (p = jx K + ix) of a site, each sample's series with
    the v-basis in the instance's QB columns (zero coefficients past Q), the
    u-degrees walked from T_0 = 1 and T_{-1} = T_1 = u', each row's
    contraction S_a over b >= 1 one FMA chain from the highest column down,
    and f = (sum_a T_a S_a + sum_{a >= 1} T_a C[a, 0]) + C[0, 0]; then for
    each component 32 lanes, lane k over the points k, k + 32, ..., the six
    sums on w_i w_j f, the xor tree, lane 0's values. ``quad_chunk`` is the
    plain route's and is not used."""
    del quad_chunk
    P, Q, M, N = cheb.coeffs.shape
    QB = cheb_gq.q_width(Q)
    C = torch.nn.functional.pad(cheb_gq.site_blocks(cheb.coeffs), (0, QB - Q))  # (S, P, QB)
    L, S, K2 = muu.shape[0], M * N, K * K
    u, v = _samples(cheb, muu, muv, su, sv, pn, K)
    tv = v + v
    tb = [torch.ones_like(v), v]
    for _ in range(2, QB):
        tb.append(tv * tb[-1] - tb[-2])
    ta, tp, tu, acc0 = torch.ones_like(u), u, u + u, torch.zeros_like(u)
    for a in range(P):
        row = C[:, a, :]
        S_a = row[:, QB - 1] * tb[QB - 1]
        for b in range(QB - 2, 0, -1):
            S_a = row[:, b] * tb[b] + S_a
        if a == 0:
            acc, c00 = S_a, row[:, 0]
        else:
            acc = ta * S_a + acc
            acc0 = ta * row[:, 0] + acc0
        ta, tp = tu * ta - tp, ta
    return _six_sums(((acc + acc0) + c00).reshape(L, K2, S), pn, K)


# ---- v2's arithmetic, transcribed -----------------------------------------------------

# explicit mantissa bits of a split's halves: TF32's 10 in float32; in
# float64 the same split at its own width (26 significant bits a half, so a
# product of halves is exact), which holds v2's algebra to JAX at 1e-10
SPLIT_BITS = {np.dtype(np.float32): 10, np.dtype(np.float64): 25}


def _rna(x, bits):
    """``x`` rounded to ``bits`` explicit mantissa bits, to nearest with ties
    away from zero, by integer masking of its bits (``cvt.rna.tf32.f32`` at
    10 bits of a float32); a NaN is kept (masking would carry an all-ones
    NaN into the sign bit)."""
    f32 = x.dtype == np.float32
    u = np.uint32 if f32 else np.uint64
    drop = (23 if f32 else 52) - bits
    with np.errstate(over="ignore"):
        r = ((x.view(u) + u(1 << (drop - 1))) & ~u((1 << drop) - 1)).view(x.dtype)
    return np.where(np.isnan(x), x, r)


def _rz(x, bits):
    """``x`` truncated to ``bits`` explicit mantissa bits (``cvt.rz``) by
    masking; a NaN is kept."""
    u = np.uint32 if x.dtype == np.float32 else np.uint64
    drop = (23 if x.dtype == np.float32 else 52) - bits
    return np.where(np.isnan(x), x, (x.view(u) & ~u((1 << drop) - 1)).view(x.dtype))


def _split(x, bits):
    """``x = hi + lo`` with ``hi = rna(x)`` and ``lo = rz(x - hi)`` (``x -
    hi`` is exact)."""
    hi = _rna(x, bits)
    return hi, _rz((x - hi).astype(x.dtype), bits)


def _fma(a, b, c):
    """``a b + c`` rounded once to ``a``'s type (a float32 product is exact
    in float64)."""
    if a.dtype == np.float32:
        return (a.astype(np.float64) * b + c).astype(np.float32)
    return a * b + c


def _mma(acc, a, b):
    """``acc + a @ b`` over one 8-deep k-step, the tensor cores' form: the
    products of the split halves and their sum in float64, added to the
    accumulator with one rounding to its type."""
    return (acc + np.matmul(a.astype(np.float64), b.astype(np.float64))).astype(acc.dtype)


def _cheb_upto(x, n):
    """``T_0 .. T_n`` at ``x`` by the three-term recurrence with FMAs."""
    two = x + x
    T = [np.ones_like(x), x]
    for _ in range(2, n + 1):
        T.append(_fma(two, T[-1], -T[-2]))
    return T


def k5_v2_transcribed(cheb, muu, muv, su, sv, pn, K, quad_chunk=0, products=3):
    """``cheb_gq_v2_kernel`` of ``csrc/cheb_gq.cu`` at every site at once, in
    the state's type: the samples padded to whole units of 64 (u' = v' = 0);
    per site the product S = T_v (samples x QB) . C^T (QB x 8 NT) on the
    tensor cores as 8-deep k-steps, with column 0 of C and its rows past P and
    columns past Q zero in the operand; T_b(v'), b < QB, by the three-term
    recurrence; both operands split as ``hi = rna(x)``, ``lo = rz(x - hi)``
    (:data:`SPLIT_BITS`), one accumulator a k-step at a time, the cross
    terms lo.hi and hi.lo of every k-step first, then hi.hi (``products=1``:
    hi.hi alone, one TF32 product); then lane t's u-degrees a = 8 n + 2 t
    and 8 n + 2 t + 1 from T_{2t}, T_{2t+1}, T_{8-2t}, T_{7-2t} (the
    three-term recurrence to T_8) by T_{a+8} = 2 T_8 T_a - T_{a-8}, its sums
    sum_a T_a S_a and sum_{a >= 1} T_a C[a, 0] a step at a time (the
    u-degrees past P, which the kernel's wider chunks add, contribute exact
    zeros), the quad's xor tree on each, f = (acc + acc0) + C[0, 0]; then
    :func:`_six_sums`. ``quad_chunk`` is not used."""
    del quad_chunk
    npdt = np.dtype(np.float32 if muu.dtype == torch.float32 else np.float64)
    bits = SPLIT_BITS[npdt]
    P, Q, M, N = cheb.coeffs.shape
    QB = cheb_gq.q_width(Q)
    NT, KS = -(-P // 8), QB // 8
    L, S, K2 = muu.shape[0], M * N, K * K
    NS = L * K2
    NSP = cheb_gq.v2_layout(L, K, P, Q)["samples"]
    u, v = (np.zeros((S, NSP), npdt) for _ in range(2))
    for dst, src in zip((u, v), _samples(cheb, muu, muv, su, sv, pn, K)):
        dst[:, :NS] = src.numpy().T
    C = cheb_gq.site_blocks(cheb.coeffs).numpy().astype(npdt)  # (S, P, Q)
    B = np.zeros((S, 8 * KS, 8 * NT), npdt)  # B[b, a] = C[a, b]; column 0 apart
    B[:, 1:Q, :P] = C[:, :, 1:].transpose(0, 2, 1)
    c0 = np.zeros((S, 1, 8 * NT), npdt)
    c0[:, 0, 1:P] = C[:, 1:, 0]
    c00 = C[:, 0, 0][:, None]
    A = np.stack(_cheb_upto(v, QB - 1)[:QB], -1)  # (S, NSP, QB)
    (a_hi, a_lo), (b_hi, b_lo) = _split(A, bits), _split(B, bits)
    Smat = np.empty((S, NSP, 8 * NT), npdt)
    for s0 in range(0, S, 64):  # sites a chunk: the float64 products stay small
        blk = slice(s0, s0 + 64)
        x = np.zeros((min(64, S - s0), NSP, 8 * NT), npdt)
        for ks in range(KS if products == 3 else 0):
            k = slice(8 * ks, 8 * ks + 8)
            x = _mma(x, a_lo[blk, :, k], b_hi[blk, k])
            x = _mma(x, a_hi[blk, :, k], b_lo[blk, k])
        for ks in range(KS):
            k = slice(8 * ks, 8 * ks + 8)
            x = _mma(x, a_hi[blk, :, k], b_hi[blk, k])
        Smat[blk] = x
    Tu = _cheb_upto(u, 8)
    two8 = Tu[8] + Tu[8]
    acc, acc0 = [], []
    for tt in range(4):
        cur, prev = [Tu[2 * tt], Tu[2 * tt + 1]], [Tu[8 - 2 * tt], Tu[7 - 2 * tt]]
        ac, ac0 = np.zeros_like(u), np.zeros_like(u)
        for nt in range(NT):
            a = [8 * nt + 2 * tt, 8 * nt + 2 * tt + 1]
            for h in (0, 1):
                ac = _fma(cur[h], Smat[..., a[h]], ac)
            for h in (0, 1):
                ac0 = _fma(cur[h], c0[..., a[h]], ac0)
            for h in (0, 1):
                prev[h], cur[h] = cur[h], _fma(two8, cur[h], -prev[h])
        acc.append(ac)
        acc0.append(ac0)

    def quad(r):  # lane 0 of the xor tree over offsets 1, 2
        return (r[0] + r[1]) + (r[2] + r[3])

    f = (quad(acc) + quad(acc0)) + c00  # (S, NSP)
    f = torch.from_numpy(np.ascontiguousarray(f[:, :NS].T)).reshape(L, K2, S)
    return _six_sums(f, pn, K)


def _version_sums(version, cheb, args, K):
    if version == "plain":
        return cheb_gq.cheb_gq_torch(cheb, *args, K, quad_chunk=K)
    if version == "v2 transcribed":
        return k5_v2_transcribed(cheb, *args, K)
    return k5_transcribed(cheb, *args, K)


# ---- the tests ------------------------------------------------------------------------

@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("case", list(CASES))
def test_cheb_sums_match_jax(case, version):
    K, P, Q, patch, window_rg = CASES[case]
    jc, cheb = _field(P, Q, patch, window_rg)
    M, N = cheb.coeffs.shape[2:]
    st = _state(3, M, N)
    want = _jax_sums(jc, st, K)
    got = _version_sums(version, cheb, _port(st), K)
    _assert_sums_match(got, want, (3, M, N))


def test_samples_leave_the_box_on_every_side():
    # the states above put samples past each of the box's four edges, so the
    # clip acts in every case
    K, _, _, patch, _ = CASES["K=9 12x8 patch 1"]
    st = _state(3, SHAPE[0] // patch, SHAPE[1] // patch)
    x = node_rule(K)[:K]
    xi, xj = np.tile(x, K), np.repeat(x, K)
    p = st["pn"][..., None]
    sp, sm = np.sqrt(1 + p), np.sqrt(1 - p)
    s, tt = (sp + sm) / 2, (sp - sm) / 2
    x1 = st["muu"][..., None] + SQRT2 * st["su"][..., None] * (s * xi + tt * xj)
    x2 = st["muv"][..., None] + SQRT2 * st["sv"][..., None] * (tt * xi + s * xj)
    lo_u, hi_u, lo_v, hi_v = BOX
    for past in (x1 < lo_u, x1 > hi_u, x2 < lo_v, x2 > hi_v):
        assert past.mean() > 0.1
    inside = (x1 > lo_u) & (x1 < hi_u) & (x2 > lo_v) & (x2 < hi_v)
    assert 0.25 < inside.mean() < 0.75


@pytest.mark.parametrize("version", VERSIONS)
def test_cheb_sums_at_the_rho_clamp_match_jax(version):
    # |rho| = 1 - 1e-5, the corr_tor corner: t ~ s, the whitened points
    # collapse onto the diagonal
    K, P, Q, patch, window_rg = CASES["K=9 12x8 patch 1"]
    jc, cheb = _field(P, Q, patch, window_rg)
    M, N = cheb.coeffs.shape[2:]
    st = _state(3, M, N)
    st["pn"] = 0.99999 * np.sign(st["pn"])
    _assert_sums_match(_version_sums(version, cheb, _port(st), K), _jax_sums(jc, st, K),
                       (3, M, N))


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("field", ["muu", "muv", "su", "pn"])
def test_nan_query_gives_nan_where_jax_does(field, version):
    # a NaN mean, sigma or correlation at one site of one component: every
    # sum there is NaN in both engines (the clip keeps it), every other
    # site's and component's agree
    K, P, Q, patch, window_rg = CASES["K=5 12x8 patch 4"]
    jc, cheb = _field(P, Q, patch, window_rg)
    M, N = cheb.coeffs.shape[2:]
    st = _state(3, M, N)
    st[field][1, 2, 3] = np.nan
    want = _jax_sums(jc, st, K)
    assert np.isnan(np.asarray(want.Ei)).sum() == 1
    _assert_sums_match(_version_sums(version, cheb, _port(st), K), want, (3, M, N))


def _sweep_case(preset, monkeypatch, transcription=k5_transcribed):
    """One Chebyshev sweep of ``preset`` with ``transcription`` in K5's place
    (the route "auto" takes on the card), from the JAX problem and init."""
    calls = []

    def route(*args, **kw):
        calls.append(1)
        return transcription(*args, **kw)

    monkeypatch.setitem(pg._NODE_CHEB, "auto", route)
    kw = dict(dtype="float64", K=5, L=2, data_term="chebyshev", cheb_p=12, cheb_q=8)
    jc = getattr(gqmap_tpu.GQMAPConfig, preset)(**kw)
    pc = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw)
    I1, I2, _ = shifted_pair(24, 28)
    fr = (-2.0, 2.0, -2.0, 2.0)
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*fr))
    pp = problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                 interior=np.asarray(jp.interior), rng=tuple(jp.rng),
                                 cheb=np_fields(jp.cheb)), device="cpu", data_term="chebyshev")
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*fr), I1.shape)
    j1, jaux = jax.jit(jg.make_sweep(jc, I1.shape))(jp, js)
    p1, paux = pg.make_sweep(pc, I1.shape)(pp, port_state(js))
    return j1, jaux, p1, paux, calls


@pytest.mark.parametrize("preset", ["full_mixture", "tpu_fast"])
def test_sweep_with_the_transcribed_kernel_matches_jax(preset, monkeypatch):
    # the slice: full_mixture (K3's edges) and tpu_fast (K2's) with the
    # Chebyshev node term through K5's arithmetic, once a sweep
    j1, jaux, p1, paux, calls = _sweep_case(preset, monkeypatch)
    assert len(calls) == 1
    assert_fields_close(p1, j1, 1e-10, 1e-12, ("w", "muu", "muv", "sigmau", "sigmav", "pn",
                                                "rou", "temperature", "it"))
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("preset", ["full_mixture", "tpu_fast"])
def test_sweep_with_the_v2_transcription_matches_jax(preset, monkeypatch):
    # the same sweeps with v2's arithmetic (at float64's width of the split)
    # in K5's place
    j1, jaux, p1, paux, calls = _sweep_case(preset, monkeypatch, k5_v2_transcribed)
    assert len(calls) == 1
    assert_fields_close(p1, j1, 1e-10, 1e-12, ("w", "muu", "muv", "sigmau", "sigmav", "pn",
                                                "rou", "temperature", "it"))
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


# ---- v2 in float32: the card's ratio rule on the CPU ---------------------------------

PROBES = ["init", "converged", "clamp"]


@functools.lru_cache(maxsize=None)
def _f32_probe(probe, L=3, K=9, P=96, Q=16, shape=(20, 24)):
    """The card tests' K5 inputs (``tests/test_torch_cuda.py::_k5_inputs``)
    on the CPU in float32 at full_mixture's 96 x 16: a field built from a
    smoothed random pair over the flow box, means over the box's range, and
    the init's wide sigmas, sigma = 0.05 or the |rho| clamp; with the plain
    float32 sums and the f64 golden on the same float32 values."""
    from gqmap_tpu_torch.ops.chebyshev import build_cheb_data
    from gqmap_tpu_torch.ops.interp import pad_cubic

    g = torch.Generator().manual_seed(sum(shape) + L + P + Q)
    I1 = torch.nn.functional.avg_pool2d(
        255 * torch.rand((1, 1) + shape, generator=g, dtype=torch.float64), 5, 1, 2,
        count_include_pad=False)[0, 0]
    cheb = build_cheb_data(I1.float(), pad_cubic(I1.roll(1, 1).float()), 1.0, 1e-6,
                           (-12.0, 4.0, -4.0, 4.0), P, Q)
    M, N = shape

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((L, M, N), generator=g, dtype=torch.float64)

    pn = torch.zeros((L, M, N), dtype=torch.float64)
    if probe == "init":
        su, sv = u(12, 13), u(4, 5)
    elif probe == "converged":
        su = sv = torch.full((L, M, N), 0.05, dtype=torch.float64)
    else:
        su, sv = u(0.01, 3), u(0.01, 3)
        pn = 0.99999 * torch.where(u(0, 1) < 0.5, -1.0, 1.0)
    st = [x.float() for x in (u(-10, 2), u(-2, 2), su, sv, pn)]
    plain = cheb_gq.cheb_gq_torch(cheb, *st, K)
    gold = cheb_gq.cheb_gq_torch(cheb._replace(coeffs=cheb.coeffs.double()),
                                 *(x.double() for x in st), K)
    return cheb, st, K, plain, gold


def _over_the_rule(got, plain, gold):
    """The sums whose error against the golden exceeds twice the plain
    version's plus 1e-6 of their magnitude (the card's ratio rule)."""
    over = {}
    for name in gold._fields:
        ref = getattr(gold, name)
        ek = float((getattr(got, name).double() - ref).abs().max())
        ep = float((getattr(plain, name).double() - ref).abs().max())
        if ek > 2.0 * ep + 1e-6 * float(ref.abs().max()):
            over[name] = (ek, ep)
    return over


@pytest.mark.parametrize("probe", PROBES)
def test_v2_transcription_holds_the_ratio_rule(probe):
    # 3xTF32 with column 0 and C[0, 0] apart: every sum within twice the
    # plain float32 version's error against the f64 golden
    cheb, st, K, plain, gold = _f32_probe(probe)
    got = k5_v2_transcribed(cheb, *st, K)
    assert all(x.dtype == torch.float32 for x in got)
    assert _over_the_rule(got, plain, gold) == {}


@pytest.mark.parametrize("probe", PROBES)
def test_one_tf32_product_fails_the_ratio_rule(probe):
    # hi.hi alone (a single TF32 product, 10 mantissa bits) breaks the rule
    # at every probe: the split is what holds v2 to it
    cheb, st, K, plain, gold = _f32_probe(probe)
    over = _over_the_rule(k5_v2_transcribed(cheb, *st, K, products=1), plain, gold)
    assert over and max(ek / ep for ek, ep in over.values()) > 20, over


def test_resolve_variant_routes_by_type_and_shape():
    f32, f64 = torch.float32, torch.float64
    for shape in ((3, 9, 96, 16), (3, 9, 64, 16), (3, 11, 96, 16), (3, 9, 96, 32),
                  (2, 5, 24, 8), (3, 9, 24, 8)):
        assert cheb_gq.resolve_variant(None, f32, *shape) == "v2"
        assert cheb_gq.resolve_variant("v1", f32, *shape) == "v1"
        assert cheb_gq.resolve_variant(None, f64, *shape) == "v1"  # the golden path
        with pytest.raises(ValueError, match="'v2' takes float32"):
            cheb_gq.resolve_variant("v2", f64, *shape)
    # P Q not a multiple of 4, a field not 16-byte aligned, more than
    # V2_MAX_Q v-degrees, a rule past V2_MAX_K points, more than V2_MAX_L
    # components, a stage over the budget: "v1"
    for shape, aligned in (((1, 11, 13, 6), True), ((3, 9, 96, 16), False),
                           ((2, 5, 200, 64), True), ((3, 5, 40, 48), True), ((1, 17, 24, 8), True),
                           ((33, 3, 24, 8), True), ((3, 9, 800, 32), True)):
        assert cheb_gq.resolve_variant(None, f32, *shape, aligned=aligned) == "v1"
        with pytest.raises(ValueError, match="'v2' takes float32"):
            cheb_gq.resolve_variant("v2", f32, *shape, aligned=aligned)
    with pytest.raises(ValueError, match="unknown cheb_gq kernel variant"):
        cheb_gq.resolve_variant("v3", f32, 3, 9, 96, 16)
    assert cheb_gq.VARIANTS == ("v1", "v2") and cheb_gq._DEFAULT_VARIANT == "v2"


@pytest.mark.parametrize("shape, want", [
    # full_mixture's 96 x 16 at K = 9: 243 samples in 4 units of 64, one
    # chunk of 96 u-degrees: 64 (mbarriers) + 81 x 32 (points) + 8 x 3 x 32
    # (whitening) + 3 x 6144 (raw ring), to 22016 (128-byte aligned), + 2 x
    # (2 x 2 x 96 x 32 (B operands, hi and lo) + 96 x 4 (column 0) + 16
    # (C[0, 0]) + 256 x (64 + 64 + 8) (T_v, T_u seeds, 2 T_8, f), to 47552)
    ((3, 9, 96, 16), dict(units=4, samples=256, stages=3, width=96, chunks=1, k_steps=2,
                          smem=117120, fits=True)),
    # the super lattice at K = 11: 363 samples in 6 units
    ((3, 11, 96, 16), dict(units=6, samples=384, stages=3, width=96, chunks=1, k_steps=2,
                           smem=153216, fits=True)),
    # tpu_fast's 64 x 16: one chunk of 64
    ((3, 9, 64, 16), dict(units=4, samples=256, stages=3, width=64, chunks=1, k_steps=2,
                          smem=102528, fits=True)),
    # width 32: 4 k-steps
    ((3, 9, 96, 32), dict(units=4, samples=256, stages=3, width=96, chunks=1, k_steps=4,
                          smem=192896, fits=True)),
    # 800 u-degrees, 9 chunks: two buffers do not fit a CTA
    ((3, 9, 800, 32), dict(units=4, samples=256, stages=2, width=96, chunks=9, k_steps=4,
                           smem=760192, fits=False)),
])
def test_v2_layout(shape, want):
    assert cheb_gq.v2_layout(*shape) == want


def test_node_kernel_routes_the_chebyshev_term_to_k5():
    C = gqmap_tpu_torch.GQMAPConfig
    for cfg in (C.full_mixture(data_term="chebyshev"), C.tpu_fast(data_term="chebyshev"),
                C.super_entropy(data_term="chebyshev"),
                C.tpu_fast(data_term="chebyshev", window_rg=2),
                C.full_mixture(data_term="chebyshev", cheb_q=64)):
        assert pg._node_kernel(cfg) == "K5"
        for route in ("auto", "cuda", "torch"):
            pg.check_supported(dataclasses.replace(cfg, node_kernel=route))
    # past 64 v-degrees the series stays plain; autodiff differentiates plain sums
    assert pg._node_kernel(C.full_mixture(data_term="chebyshev", cheb_q=65)) is None
    for bad in (dict(cheb_q=65), dict(gradient_estimator="autodiff")):
        with pytest.raises(ValueError, match="kernel K5"):
            pg.check_supported(C.full_mixture(data_term="chebyshev", node_kernel="cuda", **bad))
        pg.check_supported(C.full_mixture(data_term="chebyshev", node_kernel="auto", **bad))


def test_cpu_sweep_routes_the_chebyshev_term_through_k5():
    # "cuda" sends the node term to the kernel, which refuses CPU tensors
    # rather than fall back; "auto" and "torch" run its plain version there,
    # the same values bit for bit, and no kernel launches
    C = gqmap_tpu_torch.GQMAPConfig
    kw = dict(dtype="float64", K=5, L=2, data_term="chebyshev", cheb_p=12, cheb_q=8,
              edge_kernel="torch")
    I1, I2, _ = shifted_pair(24, 28)
    fr = gqmap_tpu_torch.FlowRange(-2.0, 2.0, -2.0, 2.0)
    cfg = C.full_mixture(**kw)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    state = pg.init_state(cfg, fr, I1.shape, device="cpu")
    before = [k.launches for k in COUNTED]
    with pytest.raises(RuntimeError, match="cheb_gq_cuda needs CUDA"):
        pg.make_sweep(C.full_mixture(node_kernel="cuda", **kw), I1.shape)(problem, state)
    a, aux_a = pg.make_sweep(cfg, I1.shape)(problem, state)
    b, aux_b = pg.make_sweep(C.full_mixture(node_kernel="torch", **kw), I1.shape)(problem, state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(aux_a, aux_b))
    assert [k.launches for k in COUNTED] == before == [0] * len(COUNTED)
    assert cheb_gq.cheb_gq_cuda in COUNTED


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    K, P, Q, patch, window_rg = CASES["K=5 16x6 patch 1"]
    _, cheb = _field(P, Q, patch, window_rg)
    st = _port(_state(3, *cheb.coeffs.shape[2:]))
    got = cheb_gq.cheb_gq(cheb, *st, K)
    want = cheb_gq.cheb_gq_torch(cheb, *st, K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        cheb_gq.cheb_gq_cuda(cheb, *st, K)
    assert cheb_gq.cheb_gq_cuda.launches == 0


def test_site_blocks_takes_the_site_major_field_only():
    # the kernel reads each site's (P, Q) block as one run: the field as
    # build_cheb_data and a shard's site_major store it; any other layout
    # raises (a copy would move the whole field every sweep)
    _, cheb = _field(12, 8, 1, 0)
    blocks = cheb_gq.site_blocks(cheb.coeffs)
    assert blocks.shape == (SHAPE[0] * SHAPE[1], 12, 8)
    assert blocks.data_ptr() == cheb.coeffs.data_ptr()
    assert torch.equal(blocks[SHAPE[1] + 2], cheb.coeffs[:, :, 1, 2])
    with pytest.raises(ValueError, match="site major"):
        cheb_gq.site_blocks(cheb.coeffs.contiguous())
    with pytest.raises(ValueError, match="site major"):
        cheb_gq.site_blocks(cheb.coeffs[:, :, :, 1:])  # a block that is not site_major's
    assert cheb_gq.site_blocks(site_major(cheb.coeffs[:, :, :, 1:])).shape == (
        SHAPE[0] * (SHAPE[1] - 1), 12, 8)


@pytest.mark.parametrize("Q, width", [(1, 8), (6, 8), (8, 8), (9, 16), (16, 16), (24, 32),
                                      (32, 32), (48, 64), (64, 64)])
def test_q_width(Q, width):
    assert cheb_gq.q_width(Q) == width


@pytest.mark.parametrize("L, K, Q, dtype, want", [
    (3, 9, 16, torch.float32, (4, 64, 1)), (3, 9, 32, torch.float32, (2, 128, 1)),
    (3, 9, 16, torch.float64, (2, 128, 1)), (1, 9, 8, torch.float32, (4, 32, 1)),
    (3, 11, 16, torch.float32, (4, 96, 1)), (3, 11, 64, torch.float32, (1, 256, 2))])
def test_lanes(L, K, Q, dtype, want):
    # whole warps a site, as few as hold its L K^2 samples at R a lane, at
    # most a CTA's 256 (then more rounds)
    R, G, rounds = cheb_gq.lanes(L, K, Q, dtype)
    assert (R, G, rounds) == want and G % 32 == 0 and G * R * rounds >= L * K * K


def test_q_width_refuses_past_max_q():
    with pytest.raises(ValueError, match="v-degrees"):
        cheb_gq.q_width(cheb_gq.MAX_Q + 1)


def test_k5_work_counts_by_hand():
    # 2 x 3 sites, L = 2, K = 3 (9 points), P = 4, Q = 2: 108 samples of
    # 2 P Q + 2 P + 2 (P + Q) = 16 + 8 + 12 = 36 operations; the 4 x 2 x 6
    # field, 5 state fields and 6 sums of 2 x 6 values, 4 bytes each
    w = roofline.k5_work((2, 3), K=3, P=4, Q=2, L=2)
    assert w == dict(bytes=(48 + 5 * 12 + 6 * 12) * 4, flops=108 * 36, roots=0)
    assert roofline.k5_work((2, 3), 3, 4, 2, 2, itemsize=8)["bytes"] == 180 * 8
    # full_mixture's Chebyshev sweep (96 x 16, L = 3, K = 9, 376 x 452): 144
    # GFLOP and 1.07 GB, bound by operations at the data sheet's rates
    big = roofline.k5_work((376, 452), 9, 96, 16, 3)
    assert big["flops"] == 3 * 376 * 452 * 81 * 3488
    b = roofline.bound(big, roofline.datasheet_rates())
    assert b["bound_by"] == "operations" and 2.14 < b["bound_ms"] < 2.16


def test_k5_work_counts_the_tensor_core_form_by_hand():
    # the same 108 samples: the contraction 2 P Q = 16 a sample on the tensor
    # cores, three products a multiply-add in 3xTF32 (one beside it); the
    # rest 2 P + 2 (P + Q) = 20 on the FMA pipe; the bytes as before
    w = roofline.k5_work((2, 3), K=3, P=4, Q=2, L=2, tensor_cores=True)
    assert w == dict(bytes=(48 + 5 * 12 + 6 * 12) * 4, flops=108 * 20, roots=0,
                     tc_flops=3 * 108 * 16, tc_flops_single=108 * 16)
    plain = roofline.k5_work((2, 3), K=3, P=4, Q=2, L=2)
    assert w["flops"] + w["tc_flops_single"] == plain["flops"]
    # full_mixture's: 380.6 GFLOP on the tensor cores (0.77 ms at the data
    # sheet's 495 TFLOP/s) against 17.2 on the FMA pipe (0.26 ms)
    big = roofline.k5_work((376, 452), 9, 96, 16, 3, tensor_cores=True)
    assert big["tc_flops"] == 3 * 3 * 376 * 452 * 81 * 3072
    b = roofline.bound(big, roofline.datasheet_rates())
    assert b["bound_by"] == "operations" and 0.768 < b["bound_ms"] < 0.770
    assert b["bound_terms_ms"]["tc_flops"] == b["bound_ms"] > 2.9 * b["bound_terms_ms"]["flops"]
