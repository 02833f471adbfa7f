"""Kernel K12's module (``kernels/window_gq.py``): the windowed bicubic node term.

The JAX package sums ``make_node_pot_windowed(base="bicubic")`` (the data
cost of ``legacy/gqmap_cpuV3.m:30-32``) by ``gq_accumulate``, an XLA scan.
Here the port's plain version (``node_window_gq_torch``) and a torch float64
transcription of the CUDA kernel's per-site loop (``k12_transcribed``,
``window_gq_kernel`` in ``csrc/node_gq.cu``: the rule's per-point constant
table in its point order, lanes over points, the displacement, floor,
fraction and weight set once a point with the 0.25 in the y weights, the
border test on global coordinates, the separable (2 rg + 4)^2 window with
four tap rows open at a time and each row's roots as it completes, the
per-tap sample with its clamp where the test fails or the query is NaN, the
site's frame-1 window by the edge pad's clamp, the xor tree, -lam / W in the
epilogue) are held to it in float64 at 1e-10 of each sum's largest
magnitude: ``full_mixture``'s K = 9 at L = 3, ``legacy_v2(data_term=
"bicubic")``'s L = 1, radii 1 and 3 (the generic instance's), a shard's
block whose taps cross the cut, windows that straddle every border of the
frame, the |rho| clamp and NaN queries (NaN exactly where JAX gives NaN). An
algebra error in the kernel's loop shows here before any card run; the
kernel itself runs on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Then one ``full_mixture(window_rg=2, L=2)`` sweep on the
CPU route, and with the transcription routed in, against JAX's sweep, the
routes, and the work count. The kernel's variant "v2" keeps v1's lanes and
arithmetic op for op (its sums are v1's bit for bit on the card), so the
one transcription holds both; v2's own layouts (the window of VV as shifted
copies, the frame-1 tile, the shared-memory budget) and the variant's
selection are checked here too.
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
from _torch_common import assert_fields_close, port_state, shifted_pair, t
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops.gq import gq_accumulate
from gqmap_tpu.ops.quadrature import build_table
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, node_gq, roofline, window_gq
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops.gq import GQRaw
from test_torch_node_gq import _cubic_weights, _quarter_weights, _sample

SQRT2 = math.sqrt(2.0)
LAM, EPS = 1.0, 1e-6
# name: (K, L, rg, frame shape, origin, local_image_shape) of each case
CASES = {
    "full_mixture K=9 L=3 rg=2": (9, 3, 2, (12, 16), None, None),
    "legacy_v2 bicubic K=9 L=1 rg=2": (9, 1, 2, (12, 16), None, None),
    "rg=1 K=5": (5, 3, 1, (12, 16), None, None),
    "rg=3 K=5": (5, 3, 3, (12, 16), None, None),
    "shard block rg=2": (9, 3, 2, (16, 24), (4, 8), (8, 12)),
    "windows straddle the border rg=2": (9, 3, 2, (12, 16), None, None),
}
STRADDLE = "windows straddle the border rg=2"
MAIN = "full_mixture K=9 L=3 rg=2"  # the shapes of the clamp and NaN probes too
VERSIONS = ["plain", "kernel transcribed"]
# XLA's CPU backend at its lowest optimisation level: the same function,
# compiled in a third of the time (the file's JAX references are most of its time)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _inputs(K, L, shape, local, seed=0, straddle=False):
    """Frames (noise in [0, 255], frame 2 frame 1 shifted with noise),
    VV = pad_cubic(I2), and a state on the covered block whose queries also
    leave the frame (means up to ~3 pixels, sigma in [0.05, 3])."""
    r = np.random.default_rng(seed + 7 * K + L)
    I1 = r.uniform(0, 255, shape)
    I2 = np.roll(I1, 1, axis=1) + r.normal(0, 5, shape)
    VV = np.asarray(jinterp.pad_cubic(jnp.asarray(I2)))
    site = (L,) + (shape if local is None else local)
    st = dict(muu=r.normal(0, 1.5, site), muv=r.normal(0, 1.5, site),
              su=r.uniform(0.05, 3, site), sv=r.uniform(0.05, 3, site),
              pn=r.uniform(-0.9, 0.9, site))
    if straddle:
        # narrow sigmas, and the means half a window off the frame at every
        # edge: the window's first tap clamped and its last not (or the
        # reverse) on each side, so the border test fails there and holds inside
        st["su"], st["sv"] = r.uniform(0.02, 0.2, site), r.uniform(0.02, 0.2, site)
        st["muu"] = r.uniform(-0.3, 0.3, site)
        st["muv"] = r.uniform(-0.3, 0.3, site)
        st["muu"][:, :, 0], st["muu"][:, :, -1] = -1.3, 1.3
        st["muv"][:, 0, :], st["muv"][:, -1, :] = -1.3, 1.3
    return I1, VV, st


def _case_inputs(case, **kw):
    K, L, rg, shape, origin, local = CASES[case]
    return _inputs(K, L, shape, local, straddle=case == STRADDLE, **kw)


def _jax_impl(I1, VV, muu, muv, su, sv, pn, origin, K, rg, local):
    f = jpot.make_node_pot_windowed(I1, VV, LAM, EPS, rg, "bicubic", origin=origin,
                                    local_image_shape=local)
    return gq_accumulate(f, muu, muv, su, sv, pn, build_table(K, 0, np.float64))


@functools.lru_cache(maxsize=None)
def _jax_compiled(shapes, with_origin, K, rg, local):
    """JAX's ``gq_accumulate`` over ``make_node_pot_windowed(base="bicubic")``,
    compiled once a set of shapes and static arguments."""
    args = [jax.ShapeDtypeStruct(sh, jnp.float64) for sh in shapes]
    origin = (jax.ShapeDtypeStruct((), jnp.int32),) * 2 if with_origin else None
    return jax.jit(_jax_impl, static_argnums=(8, 9, 10)).lower(
        *args, origin, K, rg, local).compile(compiler_options=FAST_COMPILE)


def _jax_sums(I1, VV, st, K, rg, origin, local):
    """JAX's sums. The sums are per site, so a state of fewer than 3
    components is summed as the leading components of 3 (its copies after
    it), sharing the compiled function of :data:`MAIN`'s shapes."""
    L = st["muu"].shape[0]
    site = [np.concatenate([st[k]] * 3)[:max(L, 3)] for k in ("muu", "muv", "su", "sv", "pn")]
    args = [jnp.asarray(x) for x in (I1, VV, *site)]
    fn = _jax_compiled(tuple(a.shape for a in args), origin is not None, K, rg, local)
    out = fn(*args, None if origin is None else tuple(jnp.int32(o) for o in origin))
    return type(out)(*(x[:L] for x in out))


@functools.lru_cache(maxsize=None)
def _case_jax_sums(case):
    """JAX's sums of a case, once a process (every version is held to them)."""
    K, L, rg, shape, origin, local = CASES[case]
    I1, VV, st = _case_inputs(case)
    return _jax_sums(I1, VV, st, K, rg, origin, local)


def _port_args(I1, VV, st):
    return (t(I1), t(VV), *(t(st[k]) for k in ("muu", "muv", "su", "sv", "pn")))


def _assert_sums_match(got, want, shape):
    for name in GQRaw._fields:
        g = getattr(got, name)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape == shape, name
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
        scale = np.abs(w[~nan]).max()
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=1e-10 * scale, err_msg=name)


# ---- the kernel's arithmetic, transcribed -------------------------------------------

def _shared_form(x1, x2, jj0, ii0, P, Nf, Mf):
    """The border test of ``window_points``: the window's first tap at (X0,
    Y0), no tap's query clamped and no cell capped (NaN fails it)."""
    X0, Y0 = jj0 + x1, ii0 + x2
    fx, fy = torch.floor(X0), torch.floor(Y0)
    return X0, Y0, fx, fy, (X0 >= 1) & (fx <= Nf - P) & (Y0 >= 1) & (fy <= Mf - P)


def k12_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, rg, origin=None):
    """``window_gq_kernel`` of ``csrc/node_gq.cu``: the per-point constant
    table (XJ outer, XI inner); lane ``g`` of a site's ``G`` lanes over the
    points ``g, g + G, ...`` (each lane's points evaluated together along a
    leading axis, then summed in the lane's order); per point the
    displacement, the border test, and in the shared form one weight set and
    the (P + 3)^2 window row by row (each window row's taps against the x
    weights for every tap column; tap row a = r - k takes wy[k] times it,
    k = 0..3; at r >= 3 tap row r - 3 is complete and its P roots join F),
    elsewhere each tap's clamped sample; the six sums on ``w_i w_j F``, the
    xor tree, ``-lam / W``."""
    L, M, N = muu.shape
    P = 2 * rg + 1
    G = window_gq.TILE[0]
    rule = node_gq.node_rule(K)
    x, w = rule[:K].tolist(), rule[K:].tolist()
    pts = torch.tensor([(x[i], x[j], w[i] * w[j], x[i] * x[j],
                         x[i] * x[i] + x[j] * x[j] - 1.0, x[i] * x[i] - x[j] * x[j])
                        for j in range(K) for i in range(K)], dtype=muu.dtype)
    Mo, No = I1.shape
    M2, N2 = VV.shape
    Nf, Mf = N2 - 2, M2 - 2
    r0, c0 = (0, 0) if origin is None else origin
    flat = VV.reshape(-1)
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    A1, B1, A2, B2 = su * SQRT2 * s, su * SQRT2 * tt, sv * SQRT2 * tt, sv * SQRT2 * s
    rows0 = (r0 + torch.arange(M) - rg).reshape(M, 1)
    cols0 = (c0 + torch.arange(N) - rg).reshape(1, N)
    jj0, ii0 = (cols0 + 1).to(muu.dtype), (rows0 + 1).to(muu.dtype)
    # the site's frame-1 window, by the edge pad's clamp
    i1 = [I1[(rows0 + a).clamp(0, Mo - 1), (cols0 + b).clamp(0, No - 1)]
          for a in range(P) for b in range(P)]
    lanes = []
    for g in range(G):
        xi, xj, wij, xixj, ca, cm = pts[g::G].T.reshape(6, -1, 1, 1, 1)
        x1 = A1 * xi + (B1 * xj + muu)
        x2 = A2 * xi + (B2 * xj + muv)
        X0, Y0, fx, fy, shared = _shared_form(x1, x2, jj0, ii0, P, Nf, Mf)
        wx, wy = _cubic_weights(X0 - fx), _quarter_weights(Y0 - fy)
        ix = torch.where(shared, fx, 1.0).long()  # any cell in the table where unused
        iy = torch.where(shared, fy, 1.0).long()
        base = (iy - 1) * N2 + (ix - 1)
        V = [[None] * P for _ in range(4)]
        F_shared = torch.zeros_like(x1)
        for r in range(P + 3):
            tp = [flat[base + r * N2 + k] for k in range(P + 3)]
            for b in range(P):
                h = wx[0] * tp[b]
                for k in range(1, 4):
                    h = h + wx[k] * tp[b + k]
                for k in range(4):
                    a = r - k
                    if 0 <= a < P:
                        V[a % 4][b] = wy[0] * h if k == 0 else V[a % 4][b] + wy[k] * h
            if r >= 3:
                a = r - 3
                for b in range(P):
                    d = i1[a * P + b] - V[a % 4][b]
                    F_shared = F_shared + torch.sqrt(eps + d * d)
        F_taps = torch.zeros_like(x1)
        for q in range(P * P):
            a, b = divmod(q, P)
            Vq = _sample(flat, N2, (jj0 + b) + x1, (ii0 + a) + x2, Nf, Mf)
            d = i1[q] - Vq
            F_taps = F_taps + torch.sqrt(eps + d * d)
        fv = wij * torch.where(shared, F_shared, F_taps)
        acc = [torch.zeros_like(muu) for _ in range(6)]
        for n in range(fv.shape[0]):  # the lane's points in its order
            for k, cst in enumerate((None, xi, xj, xixj, ca, cm)):
                acc[k] = acc[k] + (fv[n] if cst is None else cst[n] * fv[n])
        lanes.append(acc)
    off = G // 2
    while off:
        lanes = [[u + v for u, v in zip(lanes[g], lanes[g ^ off])] for g in range(G)]
        off //= 2
    e, sxi, sxj, sxixj, sx2a, sx2m = lanes[0]
    nl = -lam / (P * P)
    return GQRaw(nl * e, nl * (s * sxi + tt * sxj), nl * (tt * sxi + s * sxj), nl * sx2a,
                 nl * sx2m, nl * sxixj)


def _version_sums(version, args, K, rg, origin=None, local=None, quad_chunk=0):
    if version == "plain":
        return window_gq.node_window_gq_torch(*args, K, LAM, EPS, rg, origin=origin,
                                              local_image_shape=local, quad_chunk=quad_chunk)
    return k12_transcribed(*args, K, LAM, EPS, rg, origin=origin)


# ---- the sums ------------------------------------------------------------------------

@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("case", list(CASES))
def test_window_sums_match_jax(case, version):
    K, L, rg, shape, origin, local = CASES[case]
    I1, VV, st = _case_inputs(case)
    chunk = K if case == "legacy_v2 bicubic K=9 L=1 rg=2" else 0  # steps of K points, or one
    got = _version_sums(version, _port_args(I1, VV, st), K, rg, origin, local,
                        quad_chunk=chunk)
    _assert_sums_match(got, _case_jax_sums(case), st["muu"].shape)


def test_shard_block_taps_cross_the_cut():
    # the shard case's block has frame pixels on every side (its taps read
    # the true neighbours there, not the edge pad), and its sums are the
    # whole frame's sums there
    K, L, rg, shape, origin, local = CASES["shard block rg=2"]
    r0, c0 = origin
    assert r0 >= rg and c0 >= rg and r0 + local[0] + rg <= shape[0]
    assert c0 + local[1] + rg <= shape[1]
    I1, VV, st = _case_inputs("shard block rg=2")
    whole = {k: np.full((L,) + shape, 0.5 if k in ("su", "sv") else 0.0) for k in st}
    for k, v in st.items():
        whole[k][:, r0:r0 + local[0], c0:c0 + local[1]] = v
    got = k12_transcribed(*_port_args(I1, VV, whole), K, LAM, EPS, rg)
    want = _case_jax_sums("shard block rg=2")
    blk = (slice(None), slice(r0, r0 + local[0]), slice(c0, c0 + local[1]))
    for name in GQRaw._fields:
        np.testing.assert_allclose(getattr(got, name)[blk].numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(getattr(want, name))).max())


def test_straddle_case_takes_both_forms_on_every_side():
    # on each side of the frame some window's first tap is clamped and its
    # last not (or the reverse), so the border test fails there (the per-tap
    # sample) and holds inside
    K, L, rg, shape, _, _ = CASES[STRADDLE]
    I1, VV, st = _case_inputs(STRADDLE)
    P = 2 * rg + 1
    M, N = shape
    Nf, Mf = N, M
    x = node_gq.node_rule(K)[:K]
    xi, xj = np.tile(x, K), np.repeat(x, K)
    p = st["pn"][..., None]
    sp, sm = np.sqrt(1 + p), np.sqrt(1 - p)
    s, tt = (sp + sm) / 2, (sp - sm) / 2
    X0 = (np.arange(N)[:, None] + 1 - rg + st["muu"][..., None]
          + SQRT2 * st["su"][..., None] * (s * xi + tt * xj))
    Y0 = (np.arange(M)[:, None, None] + 1 - rg + st["muv"][..., None]
          + SQRT2 * st["sv"][..., None] * (tt * xi + s * xj))
    last = P - 1
    for side, first_clamped, last_clamped in (
            ("left", X0[:, :, :rg + 1] < 1, X0[:, :, :rg + 1] + last < 1),
            ("right", X0[:, :, -rg - 1:] + last > Nf, X0[:, :, -rg - 1:] > Nf),
            ("top", Y0[:, :rg + 1] < 1, Y0[:, :rg + 1] + last < 1),
            ("bottom", Y0[:, -rg - 1:] + last > Mf, Y0[:, -rg - 1:] > Mf)):
        assert (first_clamped != last_clamped).any(), side
    shared = ((X0 >= 1) & (np.floor(X0) <= Nf - P) & (Y0 >= 1) & (np.floor(Y0) <= Mf - P))
    assert shared.any() and not shared.all()


@pytest.mark.parametrize("version", VERSIONS)
def test_window_sums_at_the_rho_clamp_match_jax(version):
    # |rho| = 1 - 1e-5, the corr_tor corner: t ~ s, the whitened points
    # collapse onto the diagonal
    K, L, rg, shape, _, _ = CASES[MAIN]
    I1, VV, st = _inputs(K, L, shape, None, seed=5)
    st["pn"] = 0.99999 * np.sign(st["pn"])
    want = _jax_sums(I1, VV, st, K, rg, None, None)
    _assert_sums_match(_version_sums(version, _port_args(I1, VV, st), K, rg), want,
                       st["muu"].shape)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("field", ["muu", "muv", "su", "pn"])
def test_nan_query_gives_nan_where_jax_does(field, version):
    # a NaN mean, sigma or correlation at one site: NaN there in both
    # engines, exactly where JAX has it, the other sites agree; the kernel's
    # border test fails a NaN query by comparison and its per-tap sample
    # keeps the NaN
    K, L, rg, shape, _, _ = CASES[MAIN]
    I1, VV, st = _inputs(K, L, shape, None, seed=9)
    st[field][1, 2, 3] = np.nan
    want = _jax_sums(I1, VV, st, K, rg, None, None)
    assert np.isnan(np.asarray(want.Ei)).sum() == 1
    _assert_sums_match(_version_sums(version, _port_args(I1, VV, st), K, rg), want,
                       st["muu"].shape)


# ---- the sweep -----------------------------------------------------------------------

FR = (-2.0, 2.0, -2.0, 2.0)
FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
SWEEP = dict(dtype="float64", its=2, eval_every=2, window_rg=2, L=2, corr_tor=0.99)
SWEEP_SHAPE = (16, 20)


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    """One JAX ``full_mixture(**SWEEP)`` sweep from the init state with
    every sigma at 0.3: the problem, the state and the sweep's result."""
    jc = gqmap_tpu.GQMAPConfig.full_mixture(**SWEEP)
    I1, I2, _ = shifted_pair(*SWEEP_SHAPE)
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SWEEP_SHAPE)
    js = js._replace(sigmau=0.3 + 0 * js.sigmau, sigmav=0.3 + 0 * js.sigmav)
    sweep = jax.jit(jg.make_sweep(jc, SWEEP_SHAPE)).lower(jp, js).compile(
        compiler_options=FAST_COMPILE)
    return jp, js, sweep(jp, js)


@pytest.mark.parametrize("version", VERSIONS)
def test_full_mixture_window_sweep_matches_jax(version, monkeypatch):
    # full_mixture(window_rg=2, L=2) on the CPU route ("auto": the plain
    # version) and with K12's transcription routed in, one sweep against
    # JAX's (f64, P1's corr_tor = 0.99)
    calls = []
    if version != "plain":
        def route(*args, quad_chunk=0, local_image_shape=None, **at):
            calls.append(quad_chunk)
            return k12_transcribed(*args, **at)
        monkeypatch.setitem(pg._NODE_WINDOW, "auto", route)
    jp, js, (j1, jaux) = _jax_sweep()
    pp = problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                 interior=np.asarray(jp.interior), rng=tuple(jp.rng),
                                 cheb=None), device="cpu")
    pc = gqmap_tpu_torch.GQMAPConfig.full_mixture(**SWEEP)
    p1, paux = pg.make_sweep(pc, SWEEP_SHAPE)(pp, port_state(js))
    assert len(calls) == (0 if version == "plain" else 1)
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


# ---- the routes, the wrapper, the work count -----------------------------------------

def test_windowed_bicubic_routes_take_k12():
    C = gqmap_tpu_torch.GQMAPConfig
    for cfg in (C.full_mixture(window_rg=2), C.legacy_v2(data_term="bicubic"),
                C.full_mixture(window_rg=1, K=16), C.full_mixture(window_rg=window_gq.MAX_RG)):
        assert pg._node_kernel(cfg) == "K12"
        pg.check_supported(dataclasses.replace(cfg, node_kernel="cuda"))
    assert pg._node_kernel(C.full_mixture()) == "K4"
    # outside what K12 takes the sums stay plain: "auto" runs them, "cuda" raises
    for cfg in (C.full_mixture(window_rg=window_gq.MAX_RG + 1), C.full_mixture(window_rg=2, K=17)):
        assert pg._node_kernel(cfg) is None
        pg.check_supported(cfg)
        with pytest.raises(ValueError, match="kernel K12"):
            pg.check_supported(dataclasses.replace(cfg, node_kernel="cuda"))
    assert window_gq.takes(9, 2) and not window_gq.takes(9, 0) and not window_gq.takes(17, 2)


@pytest.mark.parametrize("route", ["cuda", "auto", "torch"])
def test_cpu_sweep_routes_the_windowed_term_through_k12(route):
    # "cuda" sends the windowed bicubic term to K12, which refuses CPU
    # tensors rather than fall back; "auto" runs its plain version there, bit
    # for bit "torch"'s, and launches nothing
    C = gqmap_tpu_torch.GQMAPConfig.full_mixture
    shape = (12, 16)
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    base = C(dtype="float64", window_rg=2, L=2, edge_kernel="torch")
    problem = pg.make_problem(base, I1, I2, fr, device="cpu")
    state = pg.init_state(base, fr, shape, device="cpu")
    before = [k.launches for k in COUNTED]
    sweep = pg.make_sweep(dataclasses.replace(base, node_kernel=route), shape)
    if route == "cuda":
        with pytest.raises(RuntimeError, match="node_window_gq_cuda needs CUDA"):
            sweep(problem, state)
    else:
        a, aux_a = sweep(problem, state)
        b, aux_b = pg.make_sweep(dataclasses.replace(base, node_kernel="torch"), shape)(
            problem, state)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(torch.equal(x, y) for x, y in zip(aux_a, aux_b))
    assert [k.launches for k in COUNTED] == before == [0] * len(COUNTED)
    assert window_gq.node_window_gq_cuda in COUNTED


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    K, L, rg, shape, _, _ = CASES["rg=1 K=5"]
    I1, VV, st = _inputs(K, L, shape, None)
    args = (*_port_args(I1, VV, st), K, LAM, EPS, rg)
    got = window_gq.node_window_gq(*args, quad_chunk=7)
    want = window_gq.node_window_gq_torch(*args, quad_chunk=7)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(RuntimeError, match="node_window_gq_cuda needs CUDA"):
        window_gq.node_window_gq_cuda(*args)
    assert window_gq.node_window_gq_cuda.launches == 0


# ---- the variants ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resolve_variant(dtype):
    # "v2" by default wherever K12 takes the term (both variants are compiled
    # for every rule up to 16 points an axis and every radius 1 to 4, in both
    # types); "v1" on request; anything else raises before a launch
    for K in range(1, window_gq.MAX_K + 1):
        for rg in range(1, window_gq.MAX_RG + 1):
            assert window_gq.resolve_variant(None, K, rg, dtype) == "v2"
            for v in window_gq.VARIANTS:
                assert window_gq.resolve_variant(v, K, rg, dtype) == v
    assert window_gq.VARIANTS == ("v1", "v2") and window_gq._DEFAULT_VARIANT == "v2"
    for bad in ("v3", "V2", ""):
        with pytest.raises(ValueError, match="unknown window_gq kernel variant"):
            window_gq.resolve_variant(bad, 9, 2, dtype)
    for K, rg in ((0, 2), (window_gq.MAX_K + 1, 2), (9, 0), (9, window_gq.MAX_RG + 1)):
        for v in (None, "v1", "v2"):
            with pytest.raises(ValueError, match="takes rules"):
                window_gq.resolve_variant(v, K, rg, dtype)
    with pytest.raises(ValueError, match="float32 or float64"):
        window_gq.resolve_variant(None, 9, 2, torch.float16)


@pytest.mark.parametrize("variant", [None, "v1", "v2"])
def test_cpu_wrapper_runs_plain_version_whatever_the_variant(variant):
    # on CPU tensors node_window_gq runs the plain version and launches
    # nothing, whichever variant is asked; the CUDA wrapper refuses them
    K, L, rg, shape, _, _ = CASES["rg=3 K=5"]
    I1, VV, st = _inputs(K, L, shape, None)
    args = (*_port_args(I1, VV, st), K, LAM, EPS, rg)
    got = window_gq.node_window_gq(*args, quad_chunk=5, variant=variant)
    want = window_gq.node_window_gq_torch(*args, quad_chunk=5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(RuntimeError, match="node_window_gq_cuda needs CUDA"):
        window_gq.node_window_gq_cuda(*args, variant=variant)
    assert window_gq.node_window_gq_cuda.launches == 0


def _copy_stride(n, size):
    """``copy_stride`` of the source: n elements padded to 16 bytes past a
    multiple of 128."""
    unit, off = 128 // size, 16 // size
    return n + (off - n % unit) % unit


def _row_stride(w, size):
    """``window_stride`` of the source: w elements padded to 64 bytes past a
    multiple of 128."""
    pad = 64 // size
    return w + (pad - w % (2 * pad)) % (2 * pad)


@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("rg", [1, 2, 3, 4])
def test_v2_shifted_copies_read_every_tap_row(rg, size):
    # v2's layouts, transcribed: the window of VV as V = 16 / size shifted
    # copies (window_shape: copy s holds element (r, c + s) at (r, c), rows
    # window_stride(cols + V - 1) apart, copies copy_stride apart), and the
    # CTA's frame-1 tile (Frame1Tile, as frame1_bytes counts it). A row that
    # starts at any column the shared form can reach is read by whole 16-byte
    # vectors at an aligned element of one copy, inside its row, and gives
    # the window's elements there; each copy starts 16 bytes of banks past
    # the one before
    V, P = 16 // size, 2 * rg + 1
    dtype = torch.float32 if size == 4 else torch.float64
    for cols, rows in ((P + 3, P + 3), (P + 4, 9), (23, 17), (40, 31)):
        ts = _row_stride(cols + V - 1, size)
        cs = _copy_stride(ts * rows, size)
        assert ts % V == 0 and cs % V == 0 and (cs * size) % 128 == 16
        window = np.arange(rows * cols, dtype=float).reshape(rows, cols)
        flat = np.full(V * cs, np.nan)
        for s in range(V):
            for r in range(rows):
                for c in range(cols - s):
                    flat[s * cs + r * ts + c] = window[r, c + s]
        for x in range(cols - (P + 3) + 1):
            start = (x % V) * cs + (x - x % V)
            for r in range(rows):
                lo = start + r * ts
                n = -(-(P + 3) // V) * V
                assert lo % V == 0 and (lo - (x % V) * cs) + n <= (r + 1) * ts
                np.testing.assert_array_equal(flat[lo:lo + P + 3], window[r, x:x + P + 3])
    # the frame-1 tile: TR + 2 rg rows, a site at tile column nt reads its P
    # pixels by whole vectors from copy nt mod V at nt - nt mod V
    _, TR, TC = window_gq.TILE
    S = -(-(TC + P + V - 2) // V) * V
    R, CS = TR + 2 * rg, _copy_stride((TR + 2 * rg) * S, size)
    assert window_gq.frame1_bytes(rg, dtype, "v2") == V * CS * size
    assert window_gq.frame1_bytes(rg, dtype, "v1") == 0
    tile = np.arange(R * (TC + 2 * rg), dtype=float).reshape(R, TC + 2 * rg)
    for nt in range(TC):
        q = nt - nt % V
        assert q + -(-P // V) * V <= S and TC + 2 * rg <= S
        for i in range(P):
            np.testing.assert_array_equal(
                [tile[i, min(q + k + nt % V, tile.shape[1] - 1)] for k in range(P)],
                tile[i, nt:nt + P])
    # the budget: the rule table, the frame-1 tile and the window fill 44 KB,
    # within the launch's 47 KB
    for K in (1, 9, 16):
        for v in window_gq.VARIANTS:
            used = (K * K * 8 * size + window_gq.frame1_bytes(rg, dtype, v)
                    + window_gq.window_budget(K, rg, dtype, v))
            assert used == 44 * 1024 <= node_gq._MAX_SMEM_BYTES
        assert window_gq.window_budget(K, rg, dtype, "v1") == node_gq.window_budget(K, dtype)


def test_work_count_and_tiles():
    # k12_work is k4_work's count a point for a P x P block, P = 2 rg + 1,
    # with the pixel lattice's frame 1 and table: at full_mixture's (3, 376,
    # 452) sites and K = 9 the data sheet's rates bound it by operations
    # (0.388 ms; roots 0.247, L1 taps 0.316), at legacy_v2's L = 1 0.129 ms
    F = roofline.FLOPS
    L, M, N, K, rg = 2, 3, 4, 9, 2
    w = roofline.k12_work((L, M, N), K, rg)
    P, pts = 5, L * M * N * K * K
    assert w["bytes"] == (5 * 24 + 12 + 5 * 6 + 6 * 24) * 4
    assert w["roots"] == pts * 25 + 2 * 24 and w["l1_bytes"] == pts * 64 * 4
    assert w["flops"] == (pts * (F["K4 point"] + F["K4 tap row"] * P * (2 * P + 3)
                                 + F["K4 pixel"] * P * P - 1) + 24 * (F["K4 site"] + 2 * K))
    four = roofline.k4_work((L, M, N), K, patch=P)
    assert four["flops"] == w["flops"] and four["roots"] == w["roots"]
    rates = roofline.datasheet_rates()
    main = roofline.bound(roofline.k12_work((3, 376, 452), 9, 2), rates)
    assert main["bound_by"] == "operations" and abs(main["bound_ms"] - 0.388) < 5e-4
    assert abs(main["bound_terms_ms"]["roots"] - 0.247) < 5e-4
    assert abs(main["bound_terms_ms"]["l1_bytes"] - 0.316) < 5e-4
    assert abs(roofline.bound(roofline.k12_work((1, 376, 452), 9, 2), rates)["bound_ms"]
               - 0.129) < 5e-4
    # K12's own tile (csrc WinTile), both variants', not K4's: window_ctas is
    # the denominator of either variant's first L1-route counter
    assert window_gq.TILE == (4, 8, 8) and window_gq.window_ctas((3, 376, 452)) == 3 * 47 * 57
    assert window_gq.window_ctas((2, 9, 17)) == 2 * 2 * 3
