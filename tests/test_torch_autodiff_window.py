"""Kernels K16 and K13 at patch 4: the autodiff estimator's windowed and
super-lattice bicubic node terms.

Under ``gradient_estimator="autodiff"`` the JAX package takes ``jax.grad`` of
``gq_ei`` (an XLA scan) on ``make_node_pot_windowed(base="bicubic")`` and on
``make_node_pot_bicubic(patch=4)``; the port sums the seven chain-rule sums
of each potential with its exact derivatives in one launch (``csrc/node_gq.cu``
``chain_block_kernel``) and scales them in ``autodiff_gq.chain_ei``. Here, in
float64:

* the plain versions (``node_window_chain_gq_torch``, ``node_chain_gq_torch``
  at ``patch=4``: ``gq_accumulate_chain`` on ``make_node_pot_windowed_chain``
  and ``make_node_pot_bicubic_chain``) and ``chain_partials`` of them against
  ``jax.grad`` of JAX's ``gq_ei``, on the init, sigma = 0.05, means on the
  flow range's integer bounds, |rho| at ``corr_tor``, integer means that put
  window taps on the frame's clamp ("ties", JAX's half slope there), NaN
  inputs and a shard's block (frame 1 at the block's pixel origin, held to
  the whole lattice's values there); each ``f`` is the value potential's bit
  for bit;
* torch transcriptions of the kernel's per-site arithmetic
  (:func:`k16_transcribed`, :func:`k13_patch4_transcribed`: the point
  table's order, a site's lanes over its points, the displacement, the shared
  form where every tap's query lies strictly inside the frame (one weight and
  slope set, the (P + 3)^2 table window summed separably, the 0.25 in the y
  weights and slopes), the per-tap sample with its clip and slopes
  elsewhere, frame 1 by the edge pad's clamp, the quotient's range record
  and a lane's exact sums again, the xor tree, lam / W) held to the same;
* one autodiff sweep and a 10-sweep segment of ``full_mixture(window_rg=2)``,
  ``legacy_v2(data_term="bicubic")`` and ``super_entropy`` against JAX's
  sweep, with the transcriptions routed in;
* ``gradcheck`` of the routes, the routing past each kernel's limit, the
  work counts and the launch geometry.

Tolerance: 1e-10 of each output's largest magnitude plus 1e-12 (the kernel
probes); sweeps at 1e-10 relative, 1e-12 absolute; segments at 1e-8. JAX's
references are compiled once a function, the kernel probes' at XLA's lowest
backend optimisation level (``FAST_COMPILE``), the sweeps' at its first.
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
from _torch_common import assert_close, assert_fields_close, port_state, shifted_pair, t
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import gq as jgq
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops.quadrature import build_table as jax_build_table
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, autodiff_gq, roofline, window_gq
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import gq, potentials
from test_torch_autodiff_gq import (_below_fast_range, _close, _cubic, _cubic_quarter,
                                    _k13_point, _root)

SQRT2 = math.sqrt(2.0)
LAMD, EPS = 1.0, 1e-6
K, L, RG = 5, 2, 2
FR = (-2.0, 2.0, -2.0, 2.0)
# kind: (frame shape, site lattice, P, STEP, OFF, lanes a site)
KINDS = {"K16": ((12, 14), (12, 14), 2 * RG + 1, 1, RG, 4),
         "K13 patch 4": ((16, 20), (4, 5), 4, 4, 0, 16)}
PROBES = ("init", "sigma 0.05", "clamp", "corr_tor", "ties", "nan", "shard block")
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _inputs(kind, probe, seed=0):
    """Frames (frame 2 frame 1 shifted with noise), VV = pad_cubic(I2) and a
    state (muu, muv, su, sv, pn) on the kind's lattice."""
    (Mo, No), site, *_ = KINDS[kind]
    r = np.random.default_rng(seed + 10 * PROBES.index(probe))
    I1 = r.uniform(0, 255, (Mo, No))
    I2 = np.roll(I1, 1, axis=1) + r.normal(0, 5, (Mo, No))
    VV = np.asarray(jinterp.pad_cubic(jnp.asarray(I2)))
    shape = (L,) + site
    st = [r.uniform(-2, 2, shape), r.uniform(-2, 2, shape), r.uniform(0.05, 1.5, shape),
          r.uniform(0.05, 1.5, shape), r.uniform(-0.9, 0.9, shape)]
    if probe == "init":
        st[2], st[3], st[4] = r.uniform(4, 5, shape), r.uniform(4, 5, shape), np.zeros(shape)
    elif probe in ("sigma 0.05", "nan", "shard block"):
        st[2], st[3] = np.full(shape, 0.05), np.full(shape, 0.05)
    elif probe == "clamp":  # every mean on an integer bound of the flow range
        st[0] = np.where(r.uniform(size=shape) < 0.5, FR[0], FR[1])
        st[1] = np.where(r.uniform(size=shape) < 0.5, FR[2], FR[3])
        st[2], st[3] = np.full(shape, 0.05), np.full(shape, 0.05)
    elif probe == "corr_tor":
        st[4] = np.where(r.uniform(size=shape) < 0.5, -1.0, 1.0) * (1.0 - 1e-5)
    elif probe == "ties":  # integer means: the centre node's taps on the clamp at every edge
        st[0], st[1] = r.integers(-3, 4, shape).astype(float), r.integers(-3, 4, shape) * 1.0
        st[2], st[3] = np.full(shape, 0.02), np.full(shape, 0.02)
    if probe == "nan":
        st[0][0, 1, 2], st[3][1, 2, 3], st[4][1, 0, 0] = np.nan, np.nan, np.nan
    return I1, VV, st


def _jax_impl(kind, I1, VV, *site):
    """JAX's gq_ei of the kind's potential and jax.grad of its sum."""
    if kind == "K16":
        f = jpot.make_node_pot_windowed(I1, VV, LAMD, EPS, RG, "bicubic")
    else:
        f = jpot.make_node_pot_bicubic(I1, VV, LAMD, EPS, patch=4)
    tab = jax_build_table(K, 0, np.float64)

    def ei(*x):
        return jgq.gq_ei(f, *x, tab)

    return ei(*site), jax.grad(lambda *x: jnp.sum(ei(*x)), argnums=tuple(range(5)))(*site)


@functools.lru_cache(maxsize=None)
def _jax_compiled(kind):
    (Mo, No), site, *_ = KINDS[kind]
    specs = [jax.ShapeDtypeStruct(s, jnp.float64)
             for s in [(Mo, No), (Mo + 2, No + 2)] + [(L,) + site] * 5]
    return jax.jit(functools.partial(_jax_impl, kind)).lower(*specs).compile(
        compiler_options=FAST_COMPILE)


@functools.lru_cache(maxsize=None)
def _jax_want(kind, probe):
    I1, VV, st = _inputs(kind, probe)
    value, grads = _jax_compiled(kind)(*(jnp.asarray(x) for x in (I1, VV, *st)))
    return np.asarray(value), [np.asarray(g) for g in grads]


def _block(kind):
    """A shard's block: its sites (rows, columns) and pixel origin and extent."""
    step = KINDS[kind][3]
    r0, c0, m, n = (3, 4, 6, 7) if kind == "K16" else (1, 1, 2, 3)
    return ((slice(None), slice(r0, r0 + m), slice(c0, c0 + n)),
            dict(origin=(r0 * step, c0 * step), local_image_shape=(m * step, n * step)))


def _port(fn, kind, probe):
    """``fn``'s sums on the probe (a shard's block where the probe is one)
    and JAX's value and gradients there."""
    I1, VV, st = _inputs(kind, probe)
    value, grads = _jax_want(kind, probe)
    site = [t(x) for x in st]
    at = {}
    if probe == "shard block":
        blk, at = _block(kind)
        site = [x[blk].contiguous() for x in site]
        value, grads = value[blk], [g[blk] for g in grads]
    extra = (RG,) if kind == "K16" else ()
    kw = {} if kind == "K16" else dict(patch=4)
    raw = fn(t(I1), t(VV), *site, K, LAMD, EPS, *extra, **kw, **at)
    return raw, site, value, grads


def _plain(kind):
    return (autodiff_gq.node_window_chain_gq_torch if kind == "K16"
            else autodiff_gq.node_chain_gq_torch)


def _holds_to_jax(raw, site, value, grads):
    _close(raw.Ei, value, "Ei")
    parts = gq.chain_partials(raw, site[2], site[3], site[4])
    for k, (p, w) in enumerate(zip(parts, grads)):
        _close(p, w, f"d/d(arg {k})")


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_version_matches_jax_grad(kind, probe):
    _holds_to_jax(*_port(_plain(kind), kind, probe))


@pytest.mark.parametrize("kind", list(KINDS))
def test_chain_potential_value_is_the_value_potentials_bit_for_bit(kind):
    # f of the chain form is the value potential's, bit for bit (its queries
    # on the clamp, NaN ones and a shard's block included)
    I1, VV, st = _inputs(kind, "ties")
    x1, x2 = t(st[0]), t(st[1])
    blk = _block(kind)[0]
    x1[0, 0, 0] = x1[0, blk[1].start, blk[2].start] = np.nan
    for at in ({}, _block(kind)[1]):
        if kind == "K16":
            fg = potentials.make_node_pot_windowed_chain(t(I1), t(VV), LAMD, EPS, RG, **at)
            f = potentials.make_node_pot_windowed(t(I1), t(VV), LAMD, EPS, RG, "bicubic", **at)
        else:
            fg = potentials.make_node_pot_bicubic_chain(t(I1), t(VV), LAMD, EPS, patch=4, **at)
            f = potentials.make_node_pot_bicubic(t(I1), t(VV), LAMD, EPS, patch=4, **at)
        if at:
            a, b = x1[blk].contiguous(), x2[blk].contiguous()
        else:
            a, b = x1, x2
        got, want = fg(a, b)[0], f(a, b)
        nan = torch.isnan(want)
        assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], want[~nan])


# ---- the kernel's arithmetic, transcribed -------------------------------------------

def chain_block_transcribed(kind, I1, VV, muu, muv, su, sv, pn, Kq, lam, eps, origin=None):
    """``chain_block_kernel`` of ``csrc/node_gq.cu`` for one kind: a site's G
    lanes over its points (lane g takes p = g, g + G, ..., ``point_table``'s
    order), the displacement as the plain version forms it, the border test on
    the block's first and last tap, the shared form (``block_chain_rows``:
    each table row's value and x-slope dots against the x weights and their
    slopes, each cell's three column dots, d, root() and the quotient, the
    totals row by row) or the per-tap v1 sample (``chain_taps``), frame 1 by
    the edge pad's clamp; a lane with a non-finite Ei sum or a recorded
    quotient below the fast division's range takes the per-tap sums at every
    point (``chain_block_exact``); the lanes' xor tree; lam / W (K16) or lam."""
    _, _, P, step, off, G = KINDS[kind]
    pts = autodiff_gq.point_constants(Kq).tolist()
    _, M, N = muu.shape
    Mo, No = I1.shape
    r0, c0 = (0, 0) if origin is None else origin
    rows = (r0 + step * torch.arange(M) - off).reshape(M, 1)
    cols = (c0 + step * torch.arange(N) - off).reshape(1, N)
    f1 = [[I1[(rows + a).clamp(0, Mo - 1), (cols + b).clamp(0, No - 1)].expand(muu.shape)
           for b in range(P)] for a in range(P)]
    o1e, o2e = su * SQRT2, sv * SQRT2
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    jj0, ii0 = (cols + 1).to(muu.dtype), (rows + 1).to(muu.dtype)
    flat, N2 = VV.reshape(-1), No + 2
    zero = torch.zeros_like(muu)

    def taps(x1, x2):
        F = X = Y = zero
        for a in range(P):
            for b in range(P):
                d, Fq, Xq, Yq = _k13_point(flat, N2, Mo, No, f1[a][b], (jj0 + b) + x1,
                                           (ii0 + a) + x2, eps, False)
                Q = d / Fq
                F, X, Y = F + Fq, X + Q * Xq, Y + Q * Yq
        return F, X, Y

    def shared(x1, x2):
        X0, Y0 = jj0 + x1, ii0 + x2
        inside = (X0 > 1) & (X0 + (P - 1) < No) & (Y0 > 1) & (Y0 + (P - 1) < Mo)
        fx, fy = torch.floor(X0), torch.floor(Y0)
        wx, dx = _cubic(X0 - fx)
        wy, dy = _cubic_quarter(Y0 - fy)
        base = ((torch.where(inside, fy, 1.0).long() - 1) * N2
                + torch.where(inside, fx, 1.0).long() - 1)
        h, hd = {}, {}

        def dot(w, tp, b):
            return w[0] * tp[b] + w[1] * tp[b + 1] + w[2] * tp[b + 2] + w[3] * tp[b + 3]

        for r in range(P + 3):
            tp = [flat[base + r * N2 + k] for k in range(P + 3)]
            for b in range(P):
                h[r, b], hd[r, b] = dot(wx, tp, b), dot(dx, tp, b)
        F = X = Y = zero
        tiny = torch.zeros_like(inside)
        for a in range(P):
            for b in range(P):
                V, Vx, Vy = wy[0] * h[a, b], wy[0] * hd[a, b], dy[0] * h[a, b]
                for k in range(1, 4):
                    hk, hdk = h[a + k, b], hd[a + k, b]
                    V, Vx, Vy = V + wy[k] * hk, Vx + wy[k] * hdk, Vy + dy[k] * hk
                d = f1[a][b] - V
                Fq = _root(eps + d * d)
                Q = d / Fq
                tiny = tiny | _below_fast_range(d)
                F, X, Y = F + Fq, X + Q * Vx, Y + Q * Vy
        return inside, (F, X, Y), inside & tiny

    def lane(g, exact):
        acc = [zero] * 7
        tiny = torch.zeros_like(muu, dtype=torch.bool) | (not eps >= 2.0 ** -120)
        for p in range(g, Kq * Kq, G):
            XI, XJ, ww = pts[p]
            x1 = o1e * (s * XI + tt * XJ) + muu
            x2 = o2e * (tt * XI + s * XJ) + muv
            tot = taps(x1, x2)
            if not exact:
                inside, sh, tn = shared(x1, x2)
                tiny = tiny | tn
                tot = [torch.where(inside, a, b) for a, b in zip(sh, tot)]
            gx, gy = ww * tot[1], ww * tot[2]
            for q, term in enumerate((ww * tot[0], gx, gy, gx * XI, gx * XJ, gy * XI, gy * XJ)):
                acc[q] = acc[q] + term
        return acc, tiny

    lanes = []
    for g in range(G):
        acc, tiny = lane(g, False)
        ok = torch.isfinite(acc[0]) & ~tiny
        if not bool(ok.all()):
            acc = [torch.where(ok, a, b) for a, b in zip(acc, lane(g, True)[0])]
        lanes.append(acc)
    w = 1
    while w < G:  # the xor tree: lane l adds lane l ^ w's sums
        lanes = [[lanes[g][q] + lanes[g ^ w][q] for q in range(7)] for g in range(G)]
        w *= 2
    scale = lam / P ** 2 if kind == "K16" else lam
    return gq.GQChainRaw(-scale * lanes[0][0], *(scale * v for v in lanes[0][1:]))


def k16_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, rg, origin=None,
                    local_image_shape=None, quad_chunk=0):
    """K16's arithmetic (:func:`chain_block_transcribed`) at the kinds'
    radius, with ``node_window_chain_gq``'s arguments."""
    assert rg == RG
    return chain_block_transcribed("K16", I1, VV, muu, muv, su, sv, pn, K, lam, eps, origin)


def k13_patch4_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, patch=1, origin=None,
                           local_image_shape=None, quad_chunk=0):
    """K13's arithmetic at patch 4 (:func:`chain_block_transcribed`), with
    ``node_chain_gq``'s arguments."""
    assert patch == 4
    return chain_block_transcribed("K13 patch 4", I1, VV, muu, muv, su, sv, pn, K, lam, eps,
                                   origin)


TRANSCRIBED = {"K16": k16_transcribed, "K13 patch 4": k13_patch4_transcribed}


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_transcription_matches_jax_grad(kind, probe):
    raw, site, value, grads = _port(TRANSCRIBED[kind], kind, probe)
    _holds_to_jax(raw, site, value, grads)
    plain = _port(_plain(kind), kind, probe)[0]
    for name in raw._fields:
        _close(getattr(raw, name), getattr(plain, name).numpy(), name)


# ---- the three paths' sweeps against JAX ----------------------------------------------

TOY = dict(K=K, dtype="float64", its=60, eval_every=10, corr_tor=0.99)
PATHS = {  # name: (preset, overrides, frame shape)
    "full_mixture window_rg=2": ("full_mixture", dict(L=L, window_rg=RG), (16, 20)),
    # P3: legacy_v2's own step is chaotic on the toy
    "legacy_v2 bicubic": ("legacy_v2", dict(data_term="bicubic", step0=0.03), (16, 20)),
    "super_entropy": ("super_entropy", dict(L=L), (32, 40)),
}
FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")


@functools.lru_cache(maxsize=None)
def _jax_path(name):
    """JAX's sweep compiled once a path (at the backend's first optimisation
    level: the segment runner's while loop compiles for many minutes), run 10
    times from the init with sigma 0.3 / 0.4: the first sweep's state and
    aux, and the tenth's state with the 10 sweeps' traces; the port's config
    and problem."""
    preset, kw, shape = PATHS[name]
    jc = getattr(gqmap_tpu.GQMAPConfig, preset)(gradient_estimator="autodiff", tor=0.0, **TOY,
                                                **kw)
    I1, I2, _ = shifted_pair(*shape)
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), shape)
    js = js._replace(sigmau=js.sigmau * 0 + 0.3, sigmav=js.sigmav * 0 + 0.4)  # narrow, not init
    sweep = jax.jit(jg.make_sweep(jc, shape)).lower(jp, js).compile(
        compiler_options={"xla_backend_optimization_level": 1})
    st, traces = js, []
    for _ in range(10):
        st, aux = sweep(jp, st)
        traces.append(aux)
        if len(traces) == 1:
            one = (st, aux)
    ten = (st, *(np.array([getattr(a, f) for a in traces])
                 for f in ("energy", "ptdmu", "ptdsigma")))
    pc = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(gradient_estimator="autodiff", tor=0.0,
                                                      **TOY, **kw)
    pp = problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                 interior=np.asarray(jp.interior), rng=tuple(jp.rng), cheb=None),
                            device="cpu")
    return pc, pp, js, one, ten, shape


def _route_transcriptions(monkeypatch):
    monkeypatch.setitem(pg._NODE_WINDOW_ADJOINT, "auto", k16_transcribed)
    monkeypatch.setitem(pg._NODE_ADJOINT, "auto", k13_patch4_transcribed)


@pytest.mark.parametrize("version", ["plain", "transcribed"])
@pytest.mark.parametrize("path", list(PATHS))
def test_one_autodiff_sweep_matches_jax(monkeypatch, path, version):
    pc, pp, js, (j1, jaux), _, shape = _jax_path(path)
    if version == "transcribed":
        _route_transcriptions(monkeypatch)
    n = [f.launches for f in COUNTED]
    p1, paux = pg.make_sweep(pc, shape)(pp, port_state(js))
    assert [f.launches for f in COUNTED] == n  # the CPU launches nothing
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("path", list(PATHS))
def test_autodiff_segment_matches_jax(monkeypatch, path):
    # ten sweeps at corr_tor = 0.99 (P1) through the segment runner, the
    # kernels' transcriptions routed in, against JAX's sweep ten times
    pc, pp, js, _, (jst, jeb, jpb, jsb), shape = _jax_path(path)
    _route_transcriptions(monkeypatch)
    pst, n, peb, ppb, psb, _ = pg.make_segment_runner(pc, shape)(pp, port_state(js), 10)
    assert n == 10
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:10], np.asarray(w)[:10], 1e-8, 0)


# ---- the routes, the limits, the counts -----------------------------------------------

def test_routes_pass_gradcheck():
    # torch.autograd.gradcheck of chain_ei on each plain version: the seven
    # sums' partials are the expectation's exact gradient
    r = np.random.default_rng(6)

    def site(shape):
        return [t(x).requires_grad_() for x in (
            r.uniform(-0.6, 0.6, shape), r.uniform(-0.6, 0.6, shape), r.uniform(0.1, 0.6, shape),
            r.uniform(0.1, 0.6, shape), r.uniform(-0.8, 0.8, shape))]

    for frame, lattice, call in (
            ((5, 6), (1, 5, 6), lambda I1, VV, *y: autodiff_gq.node_window_chain_gq_torch(
                I1, VV, *y, 3, LAMD, EPS, 1)),
            ((8, 8), (1, 2, 2), lambda I1, VV, *y: autodiff_gq.node_chain_gq_torch(
                I1, VV, *y, 3, LAMD, EPS, patch=4))):
        I1, I2 = t(r.uniform(0, 255, frame)), t(r.uniform(0, 255, frame))
        VV = t(np.asarray(jinterp.pad_cubic(jnp.asarray(I2.numpy()))))
        assert torch.autograd.gradcheck(
            lambda *x: autodiff_gq.chain_ei(lambda *y: call(I1, VV, *y), *x), site(lattice))


C = gqmap_tpu_torch.GQMAPConfig


@pytest.mark.parametrize("override, kernel, takes", [
    (dict(window_rg=4), "K16", True),
    (dict(window_rg=5), "K16", False),
    (dict(window_rg=2, K=17), "K16", False),
    (dict(patch=4, K=16), "K13", True),
    (dict(patch=4, K=17), "K13", False),
    (dict(patch=2), "K13", False),
])
def test_shape_limits_route_auto_and_refuse_cuda(monkeypatch, override, kernel, takes):
    # within a kernel's limit "auto" sweeps through its route (the plain
    # version on the CPU) once a sweep and "cuda" is taken; past it "auto"
    # sweeps through torch.autograd of the plain expectation, never calling
    # the route, and "cuda" is refused with the limit named
    cfg = C.full_mixture(gradient_estimator="autodiff", L=1, dtype="float64", quad_chunk=0,
                         **override)
    assert pg._node_term(cfg) == kernel
    assert pg._node_kernel(cfg) == (kernel if takes else None)
    cuda = dataclasses.replace(cfg, node_kernel="cuda")
    if takes:
        pg.check_supported(cuda)
    else:
        with pytest.raises(ValueError, match=rf"node_kernel='cuda' asks for kernel {kernel}, "
                                             rf"which does not take this configuration's shape: "
                                             rf"{kernel} takes"):
            pg.check_supported(cuda)
    table = pg._NODE_WINDOW_ADJOINT if kernel == "K16" else pg._NODE_ADJOINT
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return table["torch"](*a, **k)

    monkeypatch.setitem(table, "auto", counted)
    I1 = np.random.default_rng(1).uniform(0, 255, (8, 8))
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, device="cpu")
    st, aux = pg.make_sweep(cfg, (8, 8))(problem, pg.init_state(cfg, fr, (8, 8), device="cpu"))
    assert bool(torch.isfinite(aux.energy)) and len(calls) == (1 if takes else 0)


def test_variants_and_wrappers():
    # K16 has one variant ("v1"), K13 at patch 4 one ("v2"); the CUDA
    # wrappers refuse CPU tensors
    rv = autodiff_gq.resolve_variant
    assert rv("K16", None, 9, rg=2) == rv("K16", "v1", 16, rg=4) == "v1"
    assert rv("K13", None, 11, patch=4) == rv("K13", "v2", 16, patch=4) == "v2"
    assert rv("K13", None, 11) == "v2" and rv("K13", None, 17) == "v1"
    for call in (lambda: rv("K16", "v2", 9, rg=2), lambda: rv("K16", "v1", 9, rg=5),
                 lambda: rv("K13", "v1", 11, patch=4), lambda: rv("K13", "v2", 17, patch=4),
                 lambda: rv("K17", None, 9)):
        with pytest.raises(ValueError):
            call()
    assert autodiff_gq.takes("K16", 16, rg=1) and not autodiff_gq.takes("K16", 16, rg=0)
    assert autodiff_gq.takes("K13", 64) and not autodiff_gq.takes("K13", 17, patch=4)
    assert not autodiff_gq.takes("K13", 9, patch=2)
    I1, VV, st = _inputs("K16", "sigma 0.05")
    args = [t(I1), t(VV)] + [t(x) for x in st]
    for call in (lambda: autodiff_gq.node_window_chain_gq_cuda(*args, K, LAMD, EPS, RG),
                 lambda: autodiff_gq.node_chain_gq_cuda(*args, K, LAMD, EPS, patch=4)):
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_geometry_and_budgets(dtype):
    # K16's frame-1 tile is K12 v2's (the same window of shifted copies); K13
    # at patch 4 keeps one copy of its 4 x 4 sites' 16 x 16 pixels (rows 20
    # floats or 18 doubles wide); the window's budget is what the point table
    # and the tile leave of 44 KB
    size = 4 if dtype == torch.float32 else 8
    for rg in (1, 2, 3, 4):
        assert autodiff_gq.chain_frame1_bytes(rg, dtype) == window_gq.frame1_bytes(rg, dtype, "v2")
        assert autodiff_gq.chain_tile(rg) == window_gq.TILE
    assert autodiff_gq.chain_frame1_bytes(0, dtype) == 16 * (20 if size == 4 else 18) * size
    assert autodiff_gq.chain_tile(0) == (16, 4, 4)
    assert autodiff_gq.chain_ctas((3, 94, 113), 0) == 3 * 24 * 29
    assert autodiff_gq.chain_ctas((3, 376, 452), 2) == 3 * 47 * 57
    for K_, rg in ((9, 2), (11, 0), (16, 4)):
        assert autodiff_gq.chain_budget(K_, rg, dtype) == (
            44 * 1024 - K_ * K_ * 8 * size - autodiff_gq.chain_frame1_bytes(rg, dtype))


def test_work_counts():
    # k16_work: a window's P x P taps as one block of queries (its weights
    # and slopes once a point, (P + 3) P row passes of two dots, P^2 cells of
    # three column dots), one root a tap; k13_work at patch 4 the same count
    # for a super site's block, its pixels and table read once; patch 1 as
    # before
    F = roofline.FLOPS
    sites, P = 3 * 376 * 452, 5
    w = roofline.k16_work((3, 376, 452), 9, 2)
    per = F["K16 point"] + F["K16 tap row"] * (P + 3) * P + F["K16 cell"] * P * P
    assert w["flops"] == sites * 81 * per + sites * F["K13 site"]
    assert w["roots"] == sites * 81 * 25 + 2 * sites and w["l1_bytes"] == sites * 81 * 64 * 4
    assert w["bytes"] == (12 * sites + 376 * 452 + 378 * 454) * 4
    s4 = 3 * 94 * 113
    w4 = roofline.k13_work((3, 94, 113), 11, patch=4)
    assert w4["flops"] == s4 * 121 * (F["K16 point"] + F["K16 tap row"] * 7 * 4
                                      + F["K16 cell"] * 16) + s4 * F["K13 site"]
    assert w4["bytes"] == (12 * s4 + 376 * 452 + 378 * 454) * 4
    assert w4["roots"] == s4 * 121 * 16 + 2 * s4 and w4["l1_bytes"] == s4 * 121 * 49 * 4
    w1 = roofline.k13_work((3, 376, 452), 9)
    assert w1["flops"] == sites * 81 * F["K13 point"] + sites * F["K13 site"]
