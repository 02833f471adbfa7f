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
tolerance: an algebra error shows here before any card run. One
``full_mixture`` and one ``tpu_fast`` Chebyshev sweep with the
transcription in the kernel's place are held to JAX's sweeps as the plain
route is (``tests/test_torch_chebyshev.py``). Then the routing (``"K5"``
under the Stein estimator, refused under autodiff and past 64 v-degrees, no
launch on the CPU) and ``k5_work``'s counts.
"""

import dataclasses
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
VERSIONS = ["plain", "kernel transcribed"]


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
    rule = node_rule(K)
    x, w = rule[:K], rule[K:]
    p = np.tile(np.arange(K2), L)
    comp = np.repeat(np.arange(L), K2)
    xi, xj = (t(x[i]).reshape(-1, 1) for i in (p % K, p // K))
    u1, u2, o1, o2, rho = (f.reshape(L, S)[comp] for f in (muu, muv, su, sv, pn))  # (NS, S)
    sp, sm = torch.sqrt(1.0 + rho), torch.sqrt(1.0 - rho)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    zi, zj = s * xi + tt * xj, tt * xi + s * xj
    x1, x2 = o1 * SQRT2 * zi + u1, o2 * SQRT2 * zj + u2
    cu, ru = (cheb.lo_u + cheb.hi_u) * 0.5, (cheb.hi_u - cheb.lo_u) * 0.5
    cv, rv = (cheb.lo_v + cheb.hi_v) * 0.5, (cheb.hi_v - cheb.lo_v) * 0.5
    u, v = _clip((x1 - cu) / ru), _clip((x2 - cv) / rv)
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
    f = ((acc + acc0) + c00).reshape(L, K2, S)
    out = []
    for comp_l in range(L):
        lanes = []
        for k in range(32):
            sums = [torch.zeros(S, dtype=muu.dtype) for _ in range(6)]
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
    e, sxi, sxj, sxixj, sx2a, sx2m = (torch.stack([o[n] for o in out]).reshape(L, M, N)
                                      for n in range(6))
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    return GQRaw(e, s * sxi + tt * sxj, tt * sxi + s * sxj, sx2a, sx2m, sxixj)


def _version_sums(version, cheb, args, K):
    if version == "plain":
        return cheb_gq.cheb_gq_torch(cheb, *args, K, quad_chunk=K)
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


def _sweep_case(preset, monkeypatch):
    """One Chebyshev sweep of ``preset`` with the transcription in K5's place
    (the route "auto" takes on the card), from the JAX problem and init."""
    calls = []

    def route(*args, **kw):
        calls.append(1)
        return k5_transcribed(*args, **kw)

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
    assert [k.launches for k in COUNTED] == before == [0] * 5
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
