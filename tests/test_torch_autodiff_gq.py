"""The autodiff estimator's kernels K13-K15 and the cosine term's adjoint.

Under ``gradient_estimator="autodiff"`` the JAX package takes ``jax.grad`` of
the quadrature-estimated expected energy; the port computes each term's
value and the sums of its exact derivatives in one launch and scales them in
a ``torch.autograd.Function`` (``kernels/autodiff_gq.py``,
``kernels/cosine_gq.cos_ei_adjoint``). Here, in float64:

* the tie rule (ROADMAP Queue 3, D6): ``jnp.clip`` and ``jnp.maximum``
  differentiate to 1/2 on a bound, ``Tensor.clamp`` to 1; the port now clips
  by ``torch.maximum``/``torch.minimum``, so its gradient of
  ``sample_bicubic`` at a query on the frame's clamp and of ``gq_ei_diff`` at
  ``c == tiny`` are JAX's, while every value stays the clamp's bit for bit;
* the plain versions of K13 (``gq_accumulate_chain`` on the bicubic node
  potential with its derivatives), K14 (on the Charbonnier edge potential)
  and K15 (``gq_ei_diff_adjoint``, ``diff_partials``) and the cosine adjoint
  against ``jax.grad`` of the JAX package's ``gq_ei``, ``gq_ei_diff`` and
  ``cos_ei`` and against ``torch.autograd`` of the port's own, on four
  probes: the init, sigma = 0.05, means on the flow range's integer bounds
  (the centre node's queries exactly on the frame's clamp) and |rho| at
  ``corr_tor``;
* torch transcriptions of the three CUDA kernels' per-site arithmetic (K13:
  a site's four lanes over its points, the NaN-keeping clip and its slope,
  the three separable tap dots, the xor tree; K14: mirror points paired in
  flat order; K15: the neighbour read with wrap, +-x paired, the floor's tie
  rule), held to JAX at the same tolerance;
* the three paths' sweeps (``tpu_fast``, ``full_mixture`` and ``legacy_v2``
  under autodiff) through the routes' plain versions and through the
  transcriptions, against JAX's ``make_sweep`` and segment runner at
  ``corr_tor = 0.99``;
* ``torch.autograd.gradcheck`` of the Functions, and the routing.

Tolerance: 1e-10 of each output's largest magnitude plus 1e-12 absolute
(:data:`TOL`, :data:`FLOOR`); sweeps at 1e-10 relative with 1e-12 absolute,
10-sweep segments at 1e-8 (two f64 summation orders, as
``tests/test_torch_legacy.py``).
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
from gqmap_tpu.ops import cosine as jcos
from gqmap_tpu.ops import gq as jgq
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops.quadrature import build_table as jax_build_table
from gqmap_tpu.ops.quadrature import build_table_1d as jax_build_table_1d
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, autodiff_gq, cosine_gq
from gqmap_tpu_torch.kernels.edge_reduced_gq import neighbour_stacks, paired_rule_1d
from gqmap_tpu_torch.kernels.node_gq import node_rule
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import chebyshev, cosine, gq, interp, potentials
from gqmap_tpu_torch.ops.quadrature import build_table, build_table_1d, gauss_hermite

SQRT2 = math.sqrt(2.0)
TOL, FLOOR = 1e-10, 1e-12
FR = (-2.0, 2.0, -2.0, 2.0)
LAMD, LAMS, EPS = 1.0, 5.0, 1e-6
SHAPE = (12, 14)  # the kernel probes' frame and lattice (one pixel a site)
L = 2
PROBES = ("init", "sigma 0.05", "clamp", "corr_tor")
FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")


def _close(got, want, name=""):
    """Within TOL of the output's largest magnitude plus FLOOR; NaN where JAX's is."""
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
    scale = np.abs(w[~nan]).max() if (~nan).any() else 0.0
    np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=TOL * scale + FLOOR, err_msg=name)


def _frames(seed=0):
    I1, I2, _ = shifted_pair(*SHAPE, seed=seed)
    return I1, I2, np.asarray(jinterp.pad_cubic(jnp.asarray(I2)))


def _probe(name, seed=0, shape=SHAPE):
    """A state on the ``(L,) + shape`` lattice: (muu, muv, su, sv, pn, rou)."""
    r = np.random.default_rng(seed + PROBES.index(name))
    site, edge = (L,) + shape, (2, 2, L) + shape
    mu = [r.uniform(-2, 2, site), r.uniform(-2, 2, site)]
    sig = [r.uniform(0.05, 1.5, site), r.uniform(0.05, 1.5, site)]
    pn, rou = r.uniform(-0.9, 0.9, site), r.uniform(-0.9, 0.9, edge)
    if name == "init":  # init_state's: wide sigmas, no correlation
        sig = [r.uniform(0, 1, site) + 4.0, r.uniform(0, 1, site) + 4.0]
        pn, rou = np.zeros(site), np.zeros(edge)
    elif name == "sigma 0.05":
        sig = [np.full(site, 0.05), np.full(site, 0.05)]
    elif name == "clamp":  # every mean on an integer bound: the centre node's queries of
        # columns 2 and N - 3 (rows 2 and M - 3) lie on the frame's clamp
        mu = [np.where(r.uniform(size=site) < 0.5, FR[0], FR[1]),
              np.where(r.uniform(size=site) < 0.5, FR[2], FR[3])]
        sig = [np.full(site, 0.05), np.full(site, 0.05)]
    elif name == "corr_tor":
        pn = np.where(r.uniform(size=site) < 0.5, -1.0, 1.0) * (1.0 - 1e-5)
        rou = np.where(r.uniform(size=edge) < 0.5, -1.0, 1.0) * (1.0 - 1e-5)
    return (*mu, *sig, pn, rou)


def _edge_inputs(st):
    """The edge lattice's explicit ``(u1, u2, o1, o2, p)`` of a state, numpy:
    endpoint 1 broadcast, endpoint 2 the neighbour one row down and one
    column right, with wrap."""
    mu, sg = np.stack(st[:2]), np.stack(st[2:4])
    u2 = np.stack([np.roll(mu, -1, -2), np.roll(mu, -1, -1)])
    o2 = np.stack([np.roll(sg, -1, -2), np.roll(sg, -1, -1)])
    return (np.broadcast_to(mu, u2.shape).copy(), u2, np.broadcast_to(sg, o2.shape).copy(), o2,
            st[5])


def _jax_grads(fn, *args):
    """``fn``'s value and ``jax.grad`` of its sum: elementwise partials of an
    elementwise function of same-shaped inputs."""
    args = [jnp.asarray(a) for a in args]
    value = fn(*args)
    grads = jax.grad(lambda *x: jnp.sum(fn(*x)), argnums=tuple(range(len(args))))(*args)
    return value, grads


def _torch_grads(fn, *args):
    leaves = [t(a).requires_grad_() for a in args]
    value = fn(*leaves)
    return value.detach(), torch.autograd.grad(value.sum(), leaves)


# ---- the tie rule (D6) ------------------------------------------------------------

TIE_V = np.random.default_rng(3).normal(size=(6, 7))  # M = 6, N = 7
TIE_QUERIES = [(x, y) for x in (1.0, 7.0, 3.3) for y in (1.0, 6.0, 2.7)]


@pytest.mark.parametrize("Xq, Yq", TIE_QUERIES)
def test_sample_bicubic_gradient_on_the_clamp_is_jaxs(Xq, Yq):
    # jnp.clip differentiates to 1/2 on a bound; the port's sample_bicubic now
    # too (its Tensor.clamp gave 1: twice JAX's gradient there)
    VVj = jinterp.pad_cubic(jnp.asarray(TIE_V))
    want = jax.grad(lambda x, y: jinterp.sample_bicubic(VVj, x, y), argnums=(0, 1))(
        jnp.float64(Xq), jnp.float64(Yq))
    VV = interp.pad_cubic(t(TIE_V))
    X, Y = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (Xq, Yq))
    got = torch.autograd.grad(interp.sample_bicubic(VV, X, Y), (X, Y))
    _, gx, gy = interp.sample_bicubic_grad(VV, torch.tensor(Xq, dtype=torch.float64),
                                           torch.tensor(Yq, dtype=torch.float64))
    for g, e, w in zip(got, (gx, gy), want):
        assert abs(float(g) - float(w)) <= 1e-13 * max(abs(float(w)), 1.0), (float(g), float(w))
        assert abs(float(e) - float(w)) <= 1e-13 * max(abs(float(w)), 1.0), (float(e), float(w))


def _tiny_sigma():
    """A sigma whose ``(sqrt2 sigma)^2`` is float64's smallest normal number."""
    o = 2.0 ** -511 / SQRT2
    for _ in range(16):
        if (o * SQRT2) * (o * SQRT2) == np.finfo(np.float64).tiny:
            return o
        o = np.nextafter(o, np.inf if (o * SQRT2) ** 2 < np.finfo(np.float64).tiny else -np.inf)
    raise AssertionError("no sigma gives c == tiny")


def test_gq_ei_diff_gradient_at_the_floor_is_jaxs():
    # c = max(o1e^2 + o2e^2 - 2 p o1e o2e, tiny): above, on and below the
    # floor; on it and below, delta = 0, so dEi/dc is well conditioned there
    o = _tiny_sigma()
    u1, u2 = np.array([0.3, 0.1, 0.7]), np.array([-0.4, 0.1, 0.7])
    o1, o2 = np.array([0.4, o, o / 2]), np.array([0.3, 0.0, 0.0])
    p = np.array([0.2, 0.0, 0.0])
    tab_j, tab = jax_build_table_1d(13, dtype=np.float64), build_table_1d(13, dtype=np.float64)
    gdj = jpot.make_edge_pot_diff(LAMS, EPS)
    value, want = _jax_grads(lambda *x: jgq.gq_ei_diff(gdj, *x, tab_j), u1, u2, o1, o2, p)
    got_v, got = _torch_grads(lambda *x: gq.gq_ei_diff(_gd(), *x, tab), u1, u2, o1, o2, p)
    parts = gq.diff_partials(gq.gq_ei_diff_adjoint(
        potentials.make_edge_pot_diff_grad(LAMS, EPS), *map(t, (u1, u2, o1, o2, p)), tab),
        t(o1), t(o2), t(p))
    _close(got_v, value, "value")
    _close(parts[0], value, "adjoint value")
    for k, w in enumerate(want):
        _close(got[k], w, f"autograd d/d(arg {k})")
        _close(parts[k + 1], w, f"adjoint d/d(arg {k})")
    # on the floor: the tie's half slope (the clamp's whole slope gave twice it),
    # held element by element; below it, none
    assert float(want[2][1]) != 0.0 and float(want[2][2]) == 0.0
    for g in (got[2], parts[3]):
        np.testing.assert_allclose(float(g[1]), float(want[2][1]), rtol=1e-10, atol=0)
        assert float(g[2]) == 0.0


def _gd():
    return potentials.make_edge_pot_diff(LAMS, EPS)


def _parent_clip(x, lo, hi):
    return x.clamp(lo, hi)


def _parent_floor(c):
    return torch.clamp(c, min=torch.finfo(c.dtype).tiny)


def test_values_are_the_clamps_bit_for_bit(monkeypatch):
    # the repair moves derivatives at ties only: the sampler's values (NaN,
    # out-of-range and on-the-clamp queries too) and whole sweeps of every
    # path through a clip or the floor are those of Tensor.clamp, bit for bit
    r = np.random.default_rng(5)
    VV = interp.pad_cubic(t(TIE_V))
    X = t(np.concatenate([r.uniform(-2, 9, 40), [1.0, 7.0, np.nan, 0.0, 7.5]]))
    Y = t(np.concatenate([r.uniform(-2, 8, 40), [6.0, 1.0, 2.0, np.nan, -1.0]]))
    now = interp.sample_bicubic(VV, X, Y)
    I1, I2, _ = shifted_pair(10, 12)
    kw = dict(K=3, L=2, dtype="float64", cheb_p=8, cheb_q=4)
    cfgs = [gqmap_tpu_torch.GQMAPConfig.full_mixture(**kw),
            gqmap_tpu_torch.GQMAPConfig.full_mixture(gradient_estimator="autodiff", **kw),
            gqmap_tpu_torch.GQMAPConfig.full_mixture(gradient_estimator="autodiff",
                                                     node_kernel="torch", edge_kernel="torch",
                                                     **kw),
            gqmap_tpu_torch.GQMAPConfig.tpu_fast(gradient_estimator="autodiff", node_kernel="torch",
                                                 edge_kernel="torch", **kw),
            gqmap_tpu_torch.GQMAPConfig.legacy_v1(quad_var=0.05, edge_quad="reduced",
                                                  **{**kw, "L": 1}),
            gqmap_tpu_torch.GQMAPConfig.full_mixture(data_term="chebyshev",
                                                     gradient_estimator="autodiff", **kw)]

    def sweeps():
        out = []
        for cfg in cfgs:
            problem = pg.make_problem(cfg, I1, I2, gqmap_tpu_torch.FlowRange(*FR), device="cpu")
            if cfg.data_term == "quadratic":
                problem = problem._replace(init_flow=torch.zeros(I1.shape + (2,),
                                                                 dtype=torch.float64))
            st = pg.init_state(cfg, gqmap_tpu_torch.FlowRange(*FR), I1.shape, device="cpu")
            out.append(pg.make_sweep(cfg, I1.shape)(problem, st)[0])
        return out

    new = sweeps()
    monkeypatch.setattr(interp, "clip", _parent_clip)
    monkeypatch.setattr(chebyshev, "clip", _parent_clip)
    monkeypatch.setattr(gq, "_floor_tiny", _parent_floor)
    assert torch.equal(torch.isnan(now), torch.isnan(interp.sample_bicubic(VV, X, Y)))
    assert torch.equal(now.nan_to_num(), interp.sample_bicubic(VV, X, Y).nan_to_num())
    for a, b in zip(new, sweeps()):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the kernels' plain versions and the cosine adjoint, against jax.grad ----------

def _k13_jax(I1, VV, st, K):
    f = jpot.make_node_pot_bicubic(jnp.asarray(I1), jnp.asarray(VV), LAMD, EPS)
    return _jax_grads(lambda *x: jgq.gq_ei(f, *x, jax_build_table(K, 0, np.float64)), *st[:5])


def _on_the_clamp(st):
    """The sites whose centre-node query lies exactly on the frame's clamp."""
    M, N = SHAPE
    Xq = np.arange(N) + 1.0 + st[0]
    Yq = (np.arange(M) + 1.0)[:, None] + st[1]
    return int(((Xq == 1) | (Xq == N)).sum() + ((Yq == 1) | (Yq == M)).sum())


@pytest.mark.parametrize("probe", PROBES)
def test_k13_plain_version_matches_jax_grad(probe):
    I1, _, VV = _frames()
    st = _probe(probe)
    K = 5
    if probe == "clamp":
        assert _on_the_clamp(st) > 0
    value, want = _k13_jax(I1, VV, st, K)
    raw = autodiff_gq.node_chain_gq_torch(t(I1), t(VV), *map(t, st[:5]), K, LAMD, EPS)
    parts = gq.chain_partials(raw, t(st[2]), t(st[3]), t(st[4]))
    _close(raw.Ei, value, "Ei")
    fp = potentials.make_node_pot_bicubic(t(I1), t(VV), LAMD, EPS)
    tv, tg = _torch_grads(lambda *x: gq.gq_ei(fp, *x, build_table(K, 0, np.float64)), *st[:5])
    _close(tv, value, "torch Ei")
    for k, (p, w, g) in enumerate(zip(parts, want, tg)):
        _close(p, w, f"K13 d/d(arg {k})")
        _close(g, w, f"autograd d/d(arg {k})")


@pytest.mark.parametrize("probe", PROBES)
def test_k14_plain_version_matches_jax_grad(probe):
    st = _probe(probe)
    K = 5
    ed = _edge_inputs(st)
    fj = jpot.make_edge_pot(LAMS, EPS)
    value, want = _jax_grads(lambda *x: jgq.gq_ei(fj, *x, jax_build_table(K, 0, np.float64)), *ed)
    mu, sg = t(np.stack(st[:2])), t(np.stack(st[2:4]))
    u2e, o2e = neighbour_stacks(mu, sg)
    raw = autodiff_gq.edge_chain_gq_torch(mu, sg, u2e, o2e, t(st[5]), K, LAMS, EPS)
    _close(raw.Ei, value, "Ei")
    assert torch.equal(raw.A2, -raw.A1) and torch.equal(raw.Di, -raw.Ci)
    parts = gq.chain_partials(raw, sg[None], o2e, t(st[5]))
    fp = potentials.make_edge_pot(LAMS, EPS)
    tv, tg = _torch_grads(lambda *x: gq.gq_ei(fp, *x, build_table(K, 0, np.float64)), *ed)
    _close(tv, value, "torch Ei")
    for k, (p, w, g) in enumerate(zip(parts, want, tg)):
        _close(p.expand(w.shape), w, f"K14 d/d(arg {k})")
        _close(g, w, f"autograd d/d(arg {k})")


@pytest.mark.parametrize("probe", PROBES)
def test_k15_plain_version_matches_jax_grad(probe):
    st = _probe(probe)
    k1 = 13
    ed = _edge_inputs(st)
    gdj = jpot.make_edge_pot_diff(LAMS, EPS)
    value, want = _jax_grads(
        lambda *x: jgq.gq_ei_diff(gdj, *x, jax_build_table_1d(k1, dtype=np.float64)), *ed)
    mu, sg = t(np.stack(st[:2])), t(np.stack(st[2:4]))
    ei, du1, do1, do2, dp = autodiff_gq.edge_diff_adjoint_torch(mu, sg, t(st[5]), k1, LAMS, EPS)
    tv, tg = _torch_grads(lambda *x: gq.gq_ei_diff(_gd(), *x,
                                                   build_table_1d(k1, dtype=np.float64)), *ed)
    _close(ei, value, "Ei")
    _close(tv, value, "torch Ei")
    for k, (p, w, g) in enumerate(zip((du1, -du1, do1, do2, dp), want, tg)):
        _close(p, w, f"K15 d/d(arg {k})")
        _close(g, w, f"autograd d/d(arg {k})")


def _cos_data(I1, VV, A=8, B=4):
    jc = jcos.build_cos_data(jnp.asarray(I1), jnp.asarray(VV), LAMD, EPS, (-4.0, 4.0, -4.0, 4.0),
                             A=A, B=B)
    return jc, cosine.CosData(t(np.asarray(jc.coeffs)), float(jc.lo_u), float(jc.hi_u),
                              float(jc.lo_v), float(jc.hi_v))


@pytest.mark.parametrize("probe", PROBES)
def test_cosine_adjoint_matches_jax_grad(probe):
    I1, _, VV = _frames()
    jc, pc = _cos_data(I1, VV)
    st = _probe(probe)
    value, want = _jax_grads(lambda *x: jcos.cos_ei(jc, *x, a_block=2), *st[:5])
    got_v, got = _torch_grads(lambda *x: cosine_gq.cos_ei_adjoint(pc, *x), *st[:5])
    tv, tg = _torch_grads(lambda *x: cosine.cos_ei(pc, *x), *st[:5])
    _close(got_v, value, "value")
    _close(tv, value, "torch value")
    for k, (g, w, a) in enumerate(zip(got, want, tg)):
        _close(g, w, f"adjoint d/d(arg {k})")
        _close(a, w, f"autograd d/d(arg {k})")


# ---- the kernels' arithmetic, transcribed ------------------------------------------

def _clip(x, lo, hi):
    """``clip`` of ``csrc/autodiff_gq.cu``: compare and select (NaN kept), and
    its slope by the tie rule (0 at NaN)."""
    a = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0)).to(x.dtype)
    y = torch.where(x < lo, lo, x)
    b = torch.where(y < hi, 1.0, torch.where(y == hi, 0.5, 0.0)).to(x.dtype)
    return torch.where(y > hi, hi, y), a * b


def _cubic(f):
    return ((((2.0 - f) * f - 1.0) * f, (3.0 * f - 5.0) * f * f + 2.0,
             ((4.0 - 3.0 * f) * f + 1.0) * f, (f - 1.0) * f * f),
            ((4.0 - 3.0 * f) * f - 1.0, (9.0 * f - 10.0) * f, (8.0 - 9.0 * f) * f + 1.0,
             (3.0 * f - 2.0) * f))


def k13_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, origin=None,
                    local_image_shape=None, quad_chunk=0):
    """``node_chain_kernel``: a site's 4 lanes over its K^2 points (lane g
    takes g, g + 4, ..., XJ outer), per point the clip and its slope, the
    cell (the last one for a NaN query), the Keys weights and slopes, each
    tap row's value and x-slope dots, the seven sums with the point's weight
    in h; the lanes' xor tree; -lam and lam last."""
    x, w = np.split(node_rule(K), 2)
    Lx, M, N = muu.shape
    Mo, No = I1.shape
    r0, c0 = (0, 0) if origin is None else origin
    rows = (r0 + torch.arange(M)).reshape(M, 1)
    cols = (c0 + torch.arange(N)).reshape(1, N)
    i1 = I1[rows, cols]
    col, row = (cols + 1).to(muu.dtype), (rows + 1).to(muu.dtype)
    o1e, o2e = su * SQRT2, sv * SQRT2
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    flat, N2 = VV.reshape(-1), No + 2
    lanes = []
    for lane in range(4):
        acc = [torch.zeros_like(muu) for _ in range(7)]
        for k in range(lane, K * K, 4):
            j, i = divmod(k, K)
            XI, XJ, ww = float(x[i]), float(x[j]), float(w[i] * w[j])
            zi, zj = s * XI + tt * XJ, tt * XI + s * XJ
            Xc, slx = _clip(col + (o1e * zi + muu), 1.0, float(No))
            Yc, sly = _clip(row + (o2e * zj + muv), 1.0, float(Mo))
            fx, fy = torch.floor(Xc), torch.floor(Yc)
            ix = torch.where(fx <= No - 1, fx, float(No - 1))
            iy = torch.where(fy <= Mo - 1, fy, float(Mo - 1))
            wx, dx = _cubic(Xc - ix)
            wy, dy = _cubic(Yc - iy)
            base = (iy.long() - 1) * N2 + (ix.long() - 1)
            V = Vx = Vy = torch.zeros_like(muu)
            for dr in range(4):
                tap = [flat[base + dr * N2 + dc] for dc in range(4)]
                rx = wx[0] * tap[0] + wx[1] * tap[1] + wx[2] * tap[2] + wx[3] * tap[3]
                rd = dx[0] * tap[0] + dx[1] * tap[1] + dx[2] * tap[2] + dx[3] * tap[3]
                V, Vx, Vy = V + wy[dr] * rx, Vx + wy[dr] * rd, Vy + dy[dr] * rx
            diff = i1 - V * 0.25
            F = torch.sqrt(eps + diff * diff)
            h = ww * (diff / F)
            gx, gy = h * (Vx * (0.25 * slx)), h * (Vy * (0.25 * sly))
            for q, term in enumerate((ww * F, gx, gy, gx * XI, gx * XJ, gy * XI, gy * XJ)):
                acc[q] = acc[q] + term
        lanes.append(acc)
    tot = [(lanes[0][q] + lanes[1][q]) + (lanes[2][q] + lanes[3][q]) for q in range(7)]
    return gq.GQChainRaw(-lam * tot[0], *(lam * v for v in tot[1:]))


def k14_transcribed(mu, sg, u2e, o2e, rou, K, lam, eps, quad_chunk=0):
    """``edge_chain_kernel``: an element's pairs of a point and its mirror in
    ``paired_chain_rule``'s flat order, F and h = d / F of each, the even
    sums of F and h and the odd sums XI (h+ - h-), XJ (h+ - h-); the centre;
    -lam and lam last, A2, Di, Dj the negatives."""
    rule = autodiff_gq.paired_chain_rule(K)
    P = K * K // 2
    o1e, o2e = sg[None] * SQRT2, o2e * SQRT2
    delta = mu[None] - u2e
    sp, sm = torch.sqrt(1.0 + rou), torch.sqrt(1.0 - rou)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    A, B = o1e * s - o2e * tt, o1e * tt - o2e * s
    ef = eh = ci = cj = torch.zeros_like(rou)
    for k in range(P):
        q = A * rule[k] + B * rule[P + k]
        dp, dm = delta + q, delta - q
        fp, fm = torch.sqrt(eps + dp * dp), torch.sqrt(eps + dm * dm)
        hp, hm = dp / fp, dm / fm
        odd = hp - hm
        ef = ef + rule[2 * P + k] * (fp + fm)
        eh = eh + rule[2 * P + k] * (hp + hm)
        ci = ci + rule[3 * P + k] * odd
        cj = cj + rule[4 * P + k] * odd
    f0 = torch.sqrt(eps + delta * delta)
    ef, eh = ef + rule[5 * P] * f0, eh + rule[5 * P] * (delta / f0)
    return gq.GQChainRaw(-lam * ef, -lam * eh, lam * eh, -lam * ci, -lam * cj, lam * ci,
                         lam * cj)


def _k15_edges(mu, sg, rou):
    """``diff_edge`` of every edge: endpoint 2 read one row down and one
    column right with wrap, ``(o1e, o2e, delta, rc, slope)``, c floored at
    tiny with NaN kept and its slope by the tie rule."""
    u2 = torch.stack([torch.roll(mu, -1, -2), torch.roll(mu, -1, -1)])
    o2 = torch.stack([torch.roll(sg, -1, -2), torch.roll(sg, -1, -1)])
    o1e, o2e = sg[None] * SQRT2, o2 * SQRT2
    delta = mu[None] - u2
    c_raw = o1e * o1e + o2e * o2e - 2.0 * rou * o1e * o2e
    tiny = torch.finfo(c_raw.dtype).tiny
    slope = torch.where(c_raw > tiny, 1.0, torch.where(c_raw == tiny, 0.5, 0.0)).to(mu.dtype)
    rc = torch.sqrt(torch.where(c_raw < tiny, tiny, c_raw))
    return o1e, o2e, delta, rc, slope


def _k15_write(edges, rou, sums, lam):
    """``write_diff``: the value and the four derivatives from the sums."""
    o1e, o2e, _, rc, slope = edges
    h0, g0, g1 = sums
    nl = -lam * math.sqrt(math.pi)
    dc = nl * g1 * 0.5 / rc * slope
    return (nl * h0, nl * g0, dc * (2 * SQRT2) * (o1e - rou * o2e),
            dc * (2 * SQRT2) * (o2e - rou * o1e), dc * -2.0 * o1e * o2e)


def _k15_sums(edges, rule, P, eps, root=torch.sqrt):
    """An edge's H0, G0, G1 over the flat rule's P pairs in order, then the
    centre; F by ``root``."""
    _, _, delta, rc, _ = edges
    h0 = g0 = g1 = torch.zeros_like(delta)
    for k in range(P):
        sx = rc * rule[k]
        dp, dm = delta + sx, delta - sx
        fp, fm = root(eps + dp * dp), root(eps + dm * dm)
        hp, hm = dp / fp, dm / fm
        h0 = h0 + rule[P + k] * (fp + fm)
        g0 = g0 + rule[P + k] * (hp + hm)
        g1 = g1 + rule[2 * P + k] * (hp - hm)
    f0 = root(eps + delta * delta)
    return h0 + rule[4 * P] * f0, g0 + rule[4 * P] * (delta / f0), g1


def k15_transcribed(mu, sg, rou, k1, lam, eps, halo=None):
    """``edge_diff_kernel``: endpoint 2 read one row down and one column right
    with wrap, c floored at tiny with NaN kept and its slope by the tie rule,
    the +-x pairs' F and h, the centre, then the value and the four
    derivatives."""
    assert halo is None
    edges = _k15_edges(mu, sg, rou)
    return _k15_write(edges, rou, _k15_sums(edges, paired_rule_1d(k1), k1 // 2, eps), lam)


def _k15_in_range(delta, sx_min, eps):
    """``diff_in_range``: float32 numerators delta +- sx_k with delta and
    every sx_k (>= sx_min) 0 or at least 2^-36 are 0 or at least 2^-59, in
    the fast division's range, as F is at eps >= 2^-120; float64 divides as
    IEEE does."""
    if delta.dtype == torch.float64:
        return torch.ones_like(delta, dtype=torch.bool)
    lo = 2.0 ** -36
    return ((delta == 0) | (delta.abs() >= lo)) & (sx_min >= lo) & (eps >= 2.0 ** -120)


def k15_v2_transcribed(mu, sg, rou, k1, lam, eps, halo=None):
    """``edge_diff_v2_kernel``: v1's edges and sums, the pairs in the by-value
    rule's order (``EdgeRule1D``: ``x[k]``, ``w[k]``, ``wx[k]``, then
    ``wc``, :func:`paired_rule_1d`'s flat order), F by root() and h by the
    fast division. An edge whose three sums are not all finite, or whose
    numerators ``diff_in_range`` does not bound (by the least node, the
    last pair's), takes v1's sums (sqrt and the division)."""
    assert halo is None
    edges = _k15_edges(mu, sg, rou)
    rule, P = paired_rule_1d(k1), k1 // 2
    fast = _k15_sums(edges, rule, P, eps, _root)
    exact = _k15_sums(edges, rule, P, eps)
    _, _, delta, rc, _ = edges
    ok = (torch.isfinite(fast[0]) & torch.isfinite(fast[1]) & torch.isfinite(fast[2])
          & _k15_in_range(delta, rc * rule[P - 1], eps))
    return _k15_write(edges, rou, [torch.where(ok, a, b) for a, b in zip(fast, exact)], lam)


def _root(r):
    """``root()`` of the v2 kernels: sqrt's value, NaN at +inf (sqrt: inf)."""
    return torch.where(torch.isinf(r), torch.nan, torch.sqrt(r))


def _cubic_quarter(f):
    """``gqmap::chain::cubic_quarter``: ``_cubic``'s weights and slopes times
    0.25 by coefficients scaled by powers of two."""
    return ((((0.5 - 0.25 * f) * f - 0.25) * f, (0.75 * f - 1.25) * f * f + 0.5,
             ((1.0 - 0.75 * f) * f + 0.25) * f, (0.25 * f - 0.25) * f * f),
            ((1.0 - 0.75 * f) * f - 0.25, (2.25 * f - 2.5) * f, (2.0 - 2.25 * f) * f + 0.25,
             (0.75 * f - 0.5) * f))


def _k13_point(flat, N2, Mo, No, i1, Xq, Yq, eps, shared):
    """One point of every site: ``(diff, F, X, Y)``. ``shared``: K13 v2's
    shared form at the cell floor(query), no slopes, the 0.25 in the y
    weights, root(); else v1's sample (bicubic_chain.cuh: the clip and its
    slope, the NaN cell, sqrt)."""
    if shared:
        fx, fy = torch.floor(Xq), torch.floor(Yq)
        wx, dx = _cubic(Xq - fx)
        wy, dy = _cubic_quarter(Yq - fy)
        ok = (fx >= 1) & (fx <= No - 1) & (fy >= 1) & (fy <= Mo - 1)  # the gather's range only
        base = (torch.where(ok, fy, 1.0).long() - 1) * N2 + (torch.where(ok, fx, 1.0).long() - 1)
    else:
        Xc, slx = _clip(Xq, 1.0, float(No))
        Yc, sly = _clip(Yq, 1.0, float(Mo))
        fx, fy = torch.floor(Xc), torch.floor(Yc)
        ix = torch.where(fx <= No - 1, fx, float(No - 1))
        iy = torch.where(fy <= Mo - 1, fy, float(Mo - 1))
        wx, dx = _cubic(Xc - ix)
        wy, dy = _cubic(Yc - iy)
        base = (iy.long() - 1) * N2 + (ix.long() - 1)
    V = Vx = Vy = torch.zeros_like(Xq)
    for dr in range(4):
        tap = [flat[base + dr * N2 + dc] for dc in range(4)]
        rx = wx[0] * tap[0] + wx[1] * tap[1] + wx[2] * tap[2] + wx[3] * tap[3]
        rd = dx[0] * tap[0] + dx[1] * tap[1] + dx[2] * tap[2] + dx[3] * tap[3]
        V, Vx, Vy = V + wy[dr] * rx, Vx + wy[dr] * rd, Vy + dy[dr] * rx
    if shared:
        diff = i1 - V
        return diff, _root(eps + diff * diff), Vx, Vy
    diff = i1 - V * 0.25
    return diff, torch.sqrt(eps + diff * diff), Vx * (0.25 * slx), Vy * (0.25 * sly)


def k13_v2_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, origin=None,
                       local_image_shape=None, quad_chunk=0):
    """``node_chain_v2_kernel``: v1's lanes, points and tree; per point its
    constants from the table (``point_constants``), the query as v1 forms it,
    the shared form where the query lies strictly inside the frame (the test
    on global coordinates; a NaN query fails it) and v1's sample elsewhere;
    a lane whose Ei sum is not finite, or that met a quotient's numerator
    below the fast division's range (or eps below it), takes v1's sample at
    every point."""
    pts = autodiff_gq.point_constants(K).tolist()
    Lx, M, N = muu.shape
    Mo, No = I1.shape
    r0, c0 = (0, 0) if origin is None else origin
    rows = (r0 + torch.arange(M)).reshape(M, 1)
    cols = (c0 + torch.arange(N)).reshape(1, N)
    i1 = I1[rows, cols].expand(muu.shape)
    col, row = (cols + 1).to(muu.dtype), (rows + 1).to(muu.dtype)
    o1e, o2e = su * SQRT2, sv * SQRT2
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    flat, N2 = VV.reshape(-1), No + 2

    def lane_sums(lane, fallback_only):
        acc = [torch.zeros_like(muu) for _ in range(7)]
        tiny = torch.zeros_like(muu, dtype=torch.bool) | (not eps >= 2.0 ** -120)
        for k in range(lane, K * K, 4):
            XI, XJ, ww = pts[k]
            zi, zj = s * XI + tt * XJ, tt * XI + s * XJ
            Xq, Yq = col + (o1e * zi + muu), row + (o2e * zj + muv)
            v1 = _k13_point(flat, N2, Mo, No, i1, Xq, Yq, eps, False)
            if fallback_only:
                diff, F, X, Y = v1
            else:
                inside = (Xq > 1) & (Xq < No) & (Yq > 1) & (Yq < Mo)
                v2 = _k13_point(flat, N2, Mo, No, i1, Xq, Yq, eps, True)
                tiny = tiny | (inside & _below_fast_range(v2[0]))
                diff, F, X, Y = (torch.where(inside, a, b) for a, b in zip(v2, v1))
            h = ww * (diff / F)
            gx, gy = h * X, h * Y
            for q, term in enumerate((ww * F, gx, gy, gx * XI, gx * XJ, gy * XI, gy * XJ)):
                acc[q] = acc[q] + term
        return acc, tiny

    lanes = []
    for lane in range(4):
        acc, tiny = lane_sums(lane, False)
        exact, _ = lane_sums(lane, True)
        ok = torch.isfinite(acc[0]) & ~tiny
        lanes.append([torch.where(ok, a, b) for a, b in zip(acc, exact)])
    tot = [(lanes[0][q] + lanes[1][q]) + (lanes[2][q] + lanes[3][q]) for q in range(7)]
    return gq.GQChainRaw(-lam * tot[0], *(lam * v for v in tot[1:]))


def _below_fast_range(d):
    """``fast_div.cuh``'s record: a numerator with 0 < |d| < 2^-60, where
    div_fast's quotient may not be the division's (torch divides exactly, so
    here the record only selects which of two equal values is taken)."""
    return (d != 0) & (d.abs() < 2.0 ** -60)


def k14_v2_transcribed(mu, sg, u2e, o2e, rou, K, lam, eps, quad_chunk=0):
    """``edge_chain_v2_kernel``: the pairs in the by-value rule's order
    (``chain_rule_struct``: ``xi[k]``, ``xj[k]``, ``w[k]``, ``wxi[k]``,
    ``wxj[k]``, k = 0 .. P - 1, then ``wc``), F by root(), h by the fast
    division; an element whose Ei sum is not finite, or with a numerator
    below the fast division's range (or eps below it), takes v1's sums
    (sqrt and the division)."""
    rule = autodiff_gq.chain_rule_struct(K, np.float64)
    P = K * K // 2
    o1e, o2e = sg[None] * SQRT2, o2e * SQRT2
    delta = mu[None] - u2e
    sp, sm = torch.sqrt(1.0 + rou), torch.sqrt(1.0 - rou)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    A, B = o1e * s - o2e * tt, o1e * tt - o2e * s

    tiny = torch.zeros_like(rou, dtype=torch.bool) | (not eps >= 2.0 ** -120)

    def sums(root):
        nonlocal tiny
        ef = eh = ci = cj = torch.zeros_like(rou)
        for k in range(P):
            q = A * float(rule["xi"][k]) + B * float(rule["xj"][k])
            dp, dm = delta + q, delta - q
            tiny = tiny | _below_fast_range(dp) | _below_fast_range(dm)
            fp, fm = root(eps + dp * dp), root(eps + dm * dm)
            hp, hm = dp / fp, dm / fm
            odd = hp - hm
            ef = ef + float(rule["w"][k]) * (fp + fm)
            eh = eh + float(rule["w"][k]) * (hp + hm)
            ci = ci + float(rule["wxi"][k]) * odd
            cj = cj + float(rule["wxj"][k]) * odd
        f0 = root(eps + delta * delta)
        tiny = tiny | _below_fast_range(delta)
        wc = float(rule["wc"])
        return ef + wc * f0, eh + wc * (delta / f0), ci, cj

    fast, exact = sums(_root), sums(torch.sqrt)
    ok = torch.isfinite(fast[0]) & ~tiny
    ef, eh, ci, cj = (torch.where(ok, a, b) for a, b in zip(fast, exact))
    return gq.GQChainRaw(-lam * ef, -lam * eh, lam * eh, -lam * ci, -lam * cj, lam * ci,
                         lam * cj)


VERSIONS = ["plain", "transcribed", "v2 transcribed"]
K13 = {"plain": autodiff_gq.node_chain_gq_torch, "transcribed": k13_transcribed,
       "v2 transcribed": k13_v2_transcribed}
K14 = {"plain": autodiff_gq.edge_chain_gq_torch, "transcribed": k14_transcribed,
       "v2 transcribed": k14_v2_transcribed}
K15 = {"plain": autodiff_gq.edge_diff_adjoint_torch, "transcribed": k15_transcribed,
       "v2 transcribed": k15_v2_transcribed}


def _k13_probe(probe, seed=1):
    """The K13 transcription tests' inputs: frames, the state (a NaN at a few
    sites, +-inf in frame 1 and the state, or a shard's block) and the block's
    origin."""
    I1, _, VV = _frames(seed)
    st = list(_probe("sigma 0.05" if probe in ("nan", "inf", "shard block") else probe,
                     seed=seed))
    if probe == "nan":
        for k, site in ((0, (0, 3, 4)), (1, (1, 0, 0)), (4, (1, 5, 13))):
            st[k][site] = np.nan
    if probe == "inf":  # a pixel of frame 1 and two state values
        I1 = I1.copy()
        I1[5, 6], I1[0, 0] = np.inf, -np.inf
        st[0][0, 3, 4], st[2][1, 7, 2] = np.inf, np.inf
    origin = (4, 6) if probe == "shard block" else None  # frame 1 at the block's origin
    if origin is not None:
        st = [x[:, :6, :8] for x in st[:5]] + [None]
    return I1, VV, st, origin


def _k13_transcription_matches_jax(fn, probe):
    I1, VV, st, origin = _k13_probe(probe)
    K = 5
    if origin is not None:
        f = jpot.make_node_pot_bicubic(jnp.asarray(I1), jnp.asarray(VV), LAMD, EPS,
                                       origin=tuple(jnp.int32(o) for o in origin),
                                       local_image_shape=(6, 8))
        value, want = _jax_grads(lambda *x: jgq.gq_ei(f, *x, jax_build_table(K, 0, np.float64)),
                                 *st[:5])
    else:
        value, want = _k13_jax(I1, VV, st, K)
    raw = fn(t(I1), t(VV), *map(t, st[:5]), K, LAMD, EPS, origin=origin)
    plain = autodiff_gq.node_chain_gq_torch(
        t(I1), t(VV), *map(t, st[:5]), K, LAMD, EPS, origin=origin,
        local_image_shape=None if origin is None else (6, 8))
    _close(raw.Ei, value, "Ei")
    for k, (p, w) in enumerate(zip(gq.chain_partials(raw, t(st[2]), t(st[3]), t(st[4])), want)):
        _close(p, w, f"d/d(arg {k})")
    for name in raw._fields:
        _close(getattr(raw, name), getattr(plain, name).numpy(), name)


@pytest.mark.parametrize("probe", PROBES + ("nan", "shard block"))
def test_k13_transcription_matches_jax_grad(probe):
    _k13_transcription_matches_jax(k13_transcribed, probe)


@pytest.mark.parametrize("probe", PROBES + ("nan", "shard block"))
def test_k13_v2_transcription_matches_jax_grad(probe):
    _k13_transcription_matches_jax(k13_v2_transcribed, probe)


def _same(got, want, name):
    """Bit for bit, NaN where NaN."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan]), (name, f)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("probe", PROBES + ("nan", "inf", "tiny", "shard block"))
@pytest.mark.parametrize("K", [5, 9])
def test_k13_v2_transcription_is_v1s_bit_for_bit(K, probe, dtype):
    # the shared form (no clamp: both slopes 1, the 0.25 in the y weights, the
    # cell at the floor) and root() give v1's sums exactly; a query on the
    # frame's clamp ("clamp": the centre node's), a NaN query, a lane whose
    # sum root() leaves non-finite ("inf") and eps below the fast division's
    # range ("tiny": eps = 0) take v1's sample
    I1, VV, st, origin = _k13_probe("sigma 0.05" if probe == "tiny" else probe, seed=2)
    args = ([t(I1).to(dtype), t(VV).to(dtype)] + [t(x).to(dtype) for x in st[:5]]
            + [K, LAMD, 0.0 if probe == "tiny" else EPS])
    v1 = k13_transcribed(*args, origin=origin)
    v2 = k13_v2_transcribed(*args, origin=origin)
    _same(v2, v1, f"K13 {probe} {dtype}")
    if probe in ("nan", "inf"):
        assert not bool(torch.isfinite(v2.Ei).all())


def _k14_probe(probe, seed=2):
    st = list(_probe("sigma 0.05" if probe in ("nan", "inf", "tiny") else probe, seed=seed))
    if probe == "tiny":  # neighbours 1e-25 apart (or equal) at sigma 1e-27: |d| < 2^-60
        r = np.random.default_rng(seed)
        for k in (0, 1):
            st[k] = np.round(st[k] * 4) / 4 + 1e-25 * r.integers(-1, 2, st[k].shape)
        st[2], st[3] = np.full_like(st[2], 1e-27), np.full_like(st[3], 1e-27)
    if probe == "nan":
        st[0][0, 2, 3] = np.nan
        st[5][1, 0, 1, 4, 4] = np.nan
    if probe == "inf":
        st[0][0, 2, 3] = np.inf
        st[3][1, 6, 7] = np.inf
    return st


def _k14_transcription_matches_jax(fn, probe, K):
    st = _k14_probe(probe)
    ed = _edge_inputs(st)
    fj = jpot.make_edge_pot(LAMS, EPS)
    value, want = _jax_grads(lambda *x: jgq.gq_ei(fj, *x, jax_build_table(K, 0, np.float64)), *ed)
    mu, sg = t(np.stack(st[:2])), t(np.stack(st[2:4]))
    u2e, o2e = neighbour_stacks(mu, sg)
    raw = fn(mu, sg, u2e, o2e, t(st[5]), K, LAMS, EPS)
    _close(raw.Ei, value, "Ei")
    for k, (p, w) in enumerate(zip(gq.chain_partials(raw, sg[None], o2e, t(st[5])), want)):
        _close(p.expand(w.shape), w, f"d/d(arg {k})")


@pytest.mark.parametrize("probe", PROBES + ("nan",))
@pytest.mark.parametrize("K", [5, 6])
def test_k14_transcription_matches_jax_grad(probe, K):
    _k14_transcription_matches_jax(k14_transcribed, probe, K)


@pytest.mark.parametrize("probe", PROBES + ("nan",))
@pytest.mark.parametrize("K", [5, 9])
def test_k14_v2_transcription_matches_jax_grad(probe, K):
    _k14_transcription_matches_jax(k14_v2_transcribed, probe, K)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("probe", PROBES + ("nan", "inf", "tiny"))
@pytest.mark.parametrize("K", [6, 9])
def test_k14_v2_transcription_is_v1s_bit_for_bit(K, probe, dtype):
    # the by-value rule's order is v1's flat order and root() is sqrt's value,
    # so the sums are v1's exactly; an element with an infinite input (root()
    # gives NaN at +inf) or a numerator below the fast division's range
    # ("tiny") takes v1's sums
    st = _k14_probe(probe, seed=4)
    if probe == "sigma 0.05":  # o1 = o2 on a few edges: a diagonal point's q = 0
        st[2][:, 2:5], st[3][:, 2:5] = 0.37, 0.37
    mu, sg = t(np.stack(st[:2])).to(dtype), t(np.stack(st[2:4])).to(dtype)
    u2e, o2e = neighbour_stacks(mu, sg)
    args = (mu, sg, u2e, o2e, t(st[5]).to(dtype), K, LAMS, EPS)
    _same(k14_v2_transcribed(*args), k14_transcribed(*args), f"K14 {probe} {dtype}")


def test_variants_resolve():
    # "v2" by default where it is compiled: K13 up to node_gq.V2_MAX_K points an
    # axis (its point table), K14 from K = 2 and K15 from K1 = 2
    # (rule_instance.cuh); "v1" elsewhere
    assert autodiff_gq.VARIANTS == ("v1", "v2")
    rv = autodiff_gq.resolve_variant
    assert rv("K13", None, 9) == rv("K13", None, 16) == rv("K13", "v2", 3) == "v2"
    assert rv("K13", None, 17) == rv("K13", "v1", 64) == "v1"
    assert rv("K14", None, 9) == rv("K14", None, 2) == rv("K14", None, 64) == "v2"
    assert rv("K14", None, 1) == "v1"
    assert rv("K15", None, 21) == rv("K15", None, 25) == rv("K15", None, 13) == "v2"
    assert rv("K15", None, 2) == "v2" and rv("K15", None, 1) == rv("K15", "v1", 21) == "v1"
    for call in (lambda: rv("K13", "v2", 17), lambda: rv("K13", "v1", 65),
                 lambda: rv("K14", "v2", 1), lambda: rv("K13", "v3", 9),
                 lambda: rv("K15", "v2", 1), lambda: rv("K17", None, 9)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("K, dtype", [(9, np.float32), (9, np.float64), (5, np.float32)])
def test_chain_rule_struct_is_paired_chain_rules(K, dtype):
    # K14 v2's rule by value (ChainRule<T, K>): the flat rule's bytes, field by
    # field; 804 bytes for float32 at K = 9 (the source's static_assert)
    rec = autodiff_gq.chain_rule_struct(K, dtype)
    flat = autodiff_gq.paired_chain_rule(K, dtype)
    P = K * K // 2
    assert rec.tobytes() == flat.tobytes() and rec.dtype.itemsize == (5 * P + 1) * flat.itemsize
    if (K, dtype) == (9, np.float32):
        assert rec.dtype.itemsize == 804
    for k, f in enumerate(("xi", "xj", "w", "wxi", "wxj")):
        np.testing.assert_array_equal(rec[f], flat[k * P:(k + 1) * P])
    _, w = gauss_hermite(K)
    w = 0.5 * (w + w[::-1])  # symmetrised, as paired_chain_rule's
    k = np.arange(P)
    np.testing.assert_array_equal(rec["w"], (w[k % K] * w[k // K]).astype(dtype))
    assert rec["wc"] == flat[-1] == dtype(w[K // 2] ** 2 if K % 2 else 0)


@pytest.mark.parametrize("K", [3, 9, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_point_constants_are_node_rules(K, dtype):
    # K13 v2's per-point table (point_table in csrc/node_gq.cu): XJ outer, XI
    # inner, the weight product rounded once in the kernel's type, as v1 forms it
    pts = autodiff_gq.point_constants(K, dtype)
    x, w = np.split(node_rule(K, dtype), 2)
    assert pts.shape == (K * K, 3) and pts.dtype == dtype
    for p in range(K * K):
        j, i = divmod(p, K)
        assert pts[p, 0] == x[i] and pts[p, 1] == x[j] and pts[p, 2] == dtype(w[i] * w[j])


def _k15_probe(probe, seed=3):
    """The K15 transcription tests' state: NaN at a few sites and edges,
    +inf in a mean and a sigma, edges with c on and below float64's smallest
    normal ("floor"), or neighbours 1e-25 apart (or equal) at sigma 1e-27
    ("tiny": numerators below the fast division's range)."""
    st = list(_probe("sigma 0.05" if probe in ("nan", "inf", "floor", "tiny") else probe,
                     seed=seed))
    if probe == "nan":
        st[1][1, 5, 0] = np.nan
        st[5][0, 1, 0, 2, 2] = np.nan
    if probe == "inf":
        st[0][0, 2, 3] = np.inf
        st[3][1, 6, 7] = np.inf
    if probe == "floor":  # edges with c on and below float64's smallest normal
        o = _tiny_sigma()
        st[2][0, 3, 3], st[2][0, 4, 3], st[5][0, 0, 0, 3, 3] = o, 0.0, 0.0
        st[0][0, 4, 3] = st[0][0, 3, 3]
        st[2][1, 6, 6], st[2][1, 6, 7], st[5][1, 0, 1, 6, 6] = o / 2, 0.0, 0.0
    if probe == "tiny":
        r = np.random.default_rng(seed)
        for k in (0, 1):
            st[k] = np.round(st[k] * 4) / 4 + 1e-25 * r.integers(-1, 2, st[k].shape)
        st[2], st[3] = np.full_like(st[2], 1e-27), np.full_like(st[3], 1e-27)
    return st


def _k15_transcription_matches_jax(fn, probe):
    st = _k15_probe(probe)
    k1 = 13
    ed = _edge_inputs(st)
    gdj = jpot.make_edge_pot_diff(LAMS, EPS)
    value, want = _jax_grads(
        lambda *x: jgq.gq_ei_diff(gdj, *x, jax_build_table_1d(k1, dtype=np.float64)), *ed)
    mu, sg = t(np.stack(st[:2])), t(np.stack(st[2:4]))
    ei, du1, do1, do2, dp = fn(mu, sg, t(st[5]), k1, LAMS, EPS)
    _close(ei, value, "Ei")
    for k, (p, w) in enumerate(zip((du1, -du1, do1, do2, dp), want)):
        _close(p, w, f"d/d(arg {k})")
    plain = autodiff_gq.edge_diff_adjoint_torch(mu, sg, t(st[5]), k1, LAMS, EPS)
    for k, (a, b) in enumerate(zip((ei, du1, do1, do2, dp), plain)):
        _close(a, b.numpy(), f"plain output {k}")


@pytest.mark.parametrize("probe", PROBES + ("nan", "floor"))
def test_k15_transcription_matches_jax_grad(probe):
    _k15_transcription_matches_jax(k15_transcribed, probe)


@pytest.mark.parametrize("probe", PROBES + ("nan", "floor"))
def test_k15_v2_transcription_matches_jax_grad(probe):
    _k15_transcription_matches_jax(k15_v2_transcribed, probe)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("probe", PROBES + ("nan", "inf", "tiny", "floor"))
@pytest.mark.parametrize("k1", [13, 21, 25])
def test_k15_v2_transcription_is_v1s_bit_for_bit(k1, probe, dtype):
    # the by-value rule's order is v1's flat order and root() is sqrt's value,
    # so the five outputs are v1's exactly; an edge with an infinite input
    # (root() gives NaN at +inf) or a site with a numerator below the fast
    # division's range ("tiny") takes v1's sums
    st = _k15_probe(probe, seed=5)
    mu, sg = t(np.stack(st[:2])).to(dtype), t(np.stack(st[2:4])).to(dtype)
    args = (mu, sg, t(st[5]).to(dtype), k1, LAMS, EPS)
    v1 = k15_transcribed(*args)
    v2 = k15_v2_transcribed(*args)
    for k, (a, b) in enumerate(zip(v2, v1)):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan]), (probe, k)
    if probe in ("nan", "inf"):
        assert not bool(torch.isfinite(v2[0]).all())
    if probe == "tiny" and dtype == torch.float32:  # the range test sends edges to v1's sums
        edges = _k15_edges(*args[:3])
        sx_min = edges[3] * paired_rule_1d(k1)[k1 // 2 - 1]
        assert not bool(_k15_in_range(edges[2], sx_min, EPS).all())


@pytest.mark.parametrize("k1", [2, 3, 5, 13, 20, 21, 25, 41, 64])
def test_paired_rule_1d_nodes_descend(k1):
    # K15 v2 bounds an edge's numerators by the last pair's node: the least
    for dtype in (np.float64, np.float32):
        x = paired_rule_1d(k1, dtype)[:k1 // 2]
        assert bool((x > 0).all()) and bool((np.diff(x) < 0).all())


def test_k15_v2_range_test_bounds_every_numerator():
    # diff_in_range's premise, in float32: delta and s each 0 or at least 2^-36
    # in magnitude, so delta +- s is 0 or at least 2^-59 (fast_div.cuh's range
    # is 2^-60 and up), on random values and on nearly cancelling ones (s a
    # few ulps from delta, delta +- s of every sign)
    r = np.random.default_rng(0)
    n = 200_000
    mant = r.uniform(1, 2, n)
    delta = (mant * 2.0 ** r.integers(-36, 12, n)).astype(np.float32)
    delta = np.where(r.uniform(size=n) < 0.5, -delta, delta)
    delta[:1000] = 0.0
    s = (r.uniform(1, 2, n) * 2.0 ** r.integers(-36, 12, n)).astype(np.float32)
    near = np.abs(delta[1000:]).astype(np.float32)
    steps = r.integers(-4, 5, near.shape).astype(np.int32)
    near = (near.view(np.int32) + steps).view(np.float32)
    s[1000:n // 2] = np.where(np.abs(near[:n // 2 - 1000]) >= 2.0 ** -36,
                              np.abs(near[:n // 2 - 1000]), s[1000:n // 2])
    lo = np.float32(2.0 ** -36)
    assert bool(((delta == 0) | (np.abs(delta) >= lo)).all()) and bool((s >= lo).all())
    for x in (delta + s, delta - s):
        assert x.dtype == np.float32
        assert bool(((x == 0) | (np.abs(x) >= np.float32(2.0 ** -59))).all())
    assert int(((delta + s == 0) | (delta - s == 0)).sum()) > 0  # cancellation was probed


def test_k15_halo_gives_the_whole_lattices_block():
    # a shard's block with its halo (the row below, the column to its right)
    st = _probe("sigma 0.05", seed=4)
    mu, sg, rou = t(np.stack(st[:2])), t(np.stack(st[2:4])), t(st[5])
    whole = autodiff_gq.edge_diff_adjoint_torch(mu, sg, rou, 13, LAMS, EPS)
    r0, c0, m, n = 3, 5, 6, 7
    ms = torch.stack([mu, sg])
    halo = (ms[..., r0 + m:r0 + m + 1, c0:c0 + n], ms[..., r0:r0 + m, c0 + n:c0 + n + 1])
    blk = (Ellipsis, slice(r0, r0 + m), slice(c0, c0 + n))
    got = autodiff_gq.edge_diff_adjoint_torch(mu[blk], sg[blk], rou[blk], 13, LAMS, EPS,
                                              halo=halo)
    for g, w in zip(got, whole):
        _close(g, w[blk].numpy())


# ---- the Functions ---------------------------------------------------------------

def _grad_inputs(seed, shape=(1, 4, 5)):
    r = np.random.default_rng(seed)
    return [t(x).requires_grad_() for x in (
        r.uniform(-1.5, 1.5, shape), r.uniform(-1.5, 1.5, shape), r.uniform(0.1, 1.0, shape),
        r.uniform(0.1, 1.0, shape), r.uniform(-0.8, 0.8, shape))]


def test_functions_pass_gradcheck():
    r = np.random.default_rng(6)
    I1, I2 = r.uniform(0, 255, (4, 5)), r.uniform(0, 255, (4, 5))
    VV = interp.pad_cubic(t(I2))
    site = _grad_inputs(7)
    K = 3
    assert torch.autograd.gradcheck(lambda *x: autodiff_gq.chain_ei(
        lambda *y: autodiff_gq.node_chain_gq_torch(t(I1), VV, *y, K, LAMD, EPS), *x), site)
    mu, sg = (torch.stack([a, b]).detach().requires_grad_() for a, b in
              ((site[0], site[1]), (site[2], site[3])))
    rou = t(r.uniform(-0.8, 0.8, (2, 2, 1, 4, 5))).requires_grad_()

    def k14(m, s, p):
        u2e, o2e = neighbour_stacks(m, s)
        return autodiff_gq.chain_ei(lambda u1, u2, o1, o2, q: autodiff_gq.edge_chain_gq_torch(
            u1[0], o1[0], u2, o2, q, K, LAMS, EPS), m[None], u2e, s[None], o2e, p)

    assert torch.autograd.gradcheck(k14, (mu, sg, rou))
    assert torch.autograd.gradcheck(lambda m, s, p: autodiff_gq.diff_ei(
        lambda *y: autodiff_gq.edge_diff_adjoint_torch(*y, 7, LAMS, EPS), m, s, p),
        (mu, sg, rou))
    _, pc = _cos_data(r.uniform(0, 255, (4, 5)),
                      np.asarray(jinterp.pad_cubic(jnp.asarray(r.uniform(0, 255, (4, 5))))),
                      A=6, B=3)
    assert torch.autograd.gradcheck(lambda *x: cosine_gq.cos_ei_adjoint(pc, *x), site)


def test_diff_ei_backward_is_the_rolls_adjoint():
    # the gradient of K15's Ei through the in-kernel neighbour read equals
    # torch.autograd of gq_ei_diff on rolled neighbour stacks
    st = _probe("sigma 0.05", seed=8)
    W = t(np.random.default_rng(9).normal(size=(2, 2, L) + SHAPE))
    leaves = [t(np.stack(st[:2])).requires_grad_(), t(np.stack(st[2:4])).requires_grad_(),
              t(st[5]).requires_grad_()]
    got = torch.autograd.grad((W * autodiff_gq.diff_ei(
        lambda *y: autodiff_gq.edge_diff_adjoint_torch(*y, 13, LAMS, EPS), *leaves)).sum(),
        leaves)
    u2e, o2e = neighbour_stacks(leaves[0], leaves[1])
    want = torch.autograd.grad((W * gq.gq_ei_diff(
        _gd(), leaves[0][None], u2e, leaves[1][None], o2e, leaves[2],
        build_table_1d(13, dtype=np.float64))).sum(), leaves)
    for g, w in zip(got, want):
        _close(g, w.numpy())


# ---- the three paths' sweeps against JAX ----------------------------------------------

TOY = dict(K=5, dtype="float64", its=60, eval_every=10, corr_tor=0.99)
PATHS = {  # name: (preset, overrides)
    "tpu_fast": ("tpu_fast", dict(L=2, cheb_p=8, cheb_q=4, cheb_ablock=2)),
    "full_mixture": ("full_mixture", dict(L=2)),
    "legacy_v2": ("legacy_v2", dict(step0=0.03)),  # P3: its own step is chaotic on the toy
}
SWEEP_SHAPE = (16, 18)


@functools.lru_cache(maxsize=None)
def _jax_path(name):
    preset, kw = PATHS[name]
    jc = getattr(gqmap_tpu.GQMAPConfig, preset)(gradient_estimator="autodiff", tor=0.0,
                                                **TOY, **kw)
    I1, I2, _ = shifted_pair(*SWEEP_SHAPE)
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SWEEP_SHAPE)
    js = js._replace(sigmau=js.sigmau * 0 + 0.3, sigmav=js.sigmav * 0 + 0.4)  # narrow, not init
    j1, jaux = jax.jit(jg.make_sweep(jc, SWEEP_SHAPE))(jp, js)
    seg = jg.make_segment_runner(jc, SWEEP_SHAPE)(jp, js, 10)
    pc = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(gradient_estimator="autodiff", tor=0.0,
                                                      **TOY, **kw)
    pp = problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab), interior=np.asarray(jp.interior),
        rng=tuple(jp.rng), cheb=None if jp.cheb is None else
        {k: np.asarray(v) for k, v in jp.cheb._asdict().items()}), device="cpu")
    return pc, pp, js, (j1, jaux), seg


def _transcribed_routes(monkeypatch, version="transcribed"):
    monkeypatch.setitem(pg._NODE_ADJOINT, "auto", K13[version])
    monkeypatch.setitem(pg._EDGE_ROUTES["K14"], "auto", K14[version])
    monkeypatch.setitem(pg._EDGE_ROUTES["K15"], "auto", K15[version])


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("path", list(PATHS))
def test_one_autodiff_sweep_matches_jax(monkeypatch, path, version):
    pc, pp, js, (j1, jaux), _ = _jax_path(path)
    if version != "plain":
        _transcribed_routes(monkeypatch, version)
    n = [f.launches for f in COUNTED]
    p1, paux = pg.make_sweep(pc, SWEEP_SHAPE)(pp, port_state(js))
    assert [f.launches for f in COUNTED] == n  # the CPU launches nothing
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("path", list(PATHS))
def test_autodiff_segment_matches_jax(path):
    # ten sweeps at corr_tor = 0.99 (P1) through the routes' plain versions
    pc, pp, js, _, (jst, jn, jeb, jpb, jsb, _) = _jax_path(path)
    pst, n, peb, ppb, psb, _ = pg.make_segment_runner(pc, SWEEP_SHAPE)(pp, port_state(js), 10)
    assert n == int(jn) == 10
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:10], np.asarray(w)[:10], 1e-8, 0)


@pytest.mark.parametrize("path", list(PATHS))
def test_torch_routes_are_the_plain_expectation(monkeypatch, path):
    # node_kernel = edge_kernel = "torch": torch.autograd of gq_ei / gq_ei_diff /
    # cos_ei, no Function; the same sweep within the two summation orders
    pc, pp, js, (j1, _), _ = _jax_path(path)

    def refuse(*a, **k):
        raise AssertionError("the torch route took a kernel's Function")

    monkeypatch.setattr(pg, "chain_ei", refuse)
    monkeypatch.setattr(pg, "diff_ei", refuse)
    monkeypatch.setattr(pg, "cos_ei_adjoint", refuse)
    cfg = dataclasses.replace(pc, node_kernel="torch", edge_kernel="torch")
    p1, _ = pg.make_sweep(cfg, SWEEP_SHAPE)(pp, port_state(js))
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)


# ---- routing ----------------------------------------------------------------------

C = gqmap_tpu_torch.GQMAPConfig
AD = dict(gradient_estimator="autodiff")


@pytest.mark.parametrize("cfg, node, edge", [
    (C.tpu_fast(**AD), "K1", "K15"),
    (C.full_mixture(**AD), "K13", "K14"),
    (C.legacy_v2(**AD), "K6", "K14"),
    (C.legacy_v2(edge_quad="reduced", **AD), "K6", "K15"),
    (C.blockmatch_v2(**AD), "K6", "K14"),
    (C.tpu_fast_super(**AD), "K1", "K15"),
    (C.super_entropy(**AD), "K13", "K14"),
    (C.full_mixture(window_rg=2, **AD), "K16", "K14"),
    (C.full_mixture(data_term="chebyshev", **AD), None, "K14"),
    (C.legacy_v1(**AD), None, None),
    (C.legacy_v1(edge_quad="reduced", **AD), None, None),
])
def test_autodiff_kernels_are_named(cfg, node, edge):
    assert pg._node_kernel(cfg) == node and pg._edge_kernel(cfg) == edge
    for field, kernel in (("node_kernel", node), ("edge_kernel", edge)):
        for route in ("auto", "torch"):
            pg.check_supported(dataclasses.replace(cfg, **{field: route}))
        if kernel is None:  # "cuda" where no kernel computes the term raises, naming them
            with pytest.raises(ValueError, match="kernel K1.*kernel K13" if field == "node_kernel"
                               else "kernel K14 or K15"):
                pg.check_supported(dataclasses.replace(cfg, **{field: "cuda"}))
        else:
            pg.check_supported(dataclasses.replace(cfg, **{field: "cuda"}))


@pytest.mark.parametrize("field", ["node_kernel", "edge_kernel"])
def test_cuda_route_refuses_cpu_tensors(field):
    # "cuda" sends the term to its kernel, which refuses CPU tensors rather
    # than fall back to its plain version
    pc, pp, js, _, _ = _jax_path("full_mixture")
    sweep = pg.make_sweep(dataclasses.replace(pc, **{field: "cuda"}), SWEEP_SHAPE)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        sweep(pp, port_state(js))


def test_wrappers_raise_for_cpu_tensors():
    st = [t(x) for x in _probe("sigma 0.05")]
    I1, _, VV = _frames()
    mu, sg = torch.stack(st[:2]), torch.stack(st[2:4])
    u2e, o2e = neighbour_stacks(mu, sg)
    for call in (lambda: autodiff_gq.node_chain_gq_cuda(t(I1), t(VV), *st[:5], 5, LAMD, EPS),
                 lambda: autodiff_gq.edge_chain_gq_cuda(mu, sg, u2e, o2e, st[5], 5, LAMS, EPS),
                 lambda: autodiff_gq.edge_diff_adjoint_cuda(mu, sg, st[5], 13, LAMS, EPS)):
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            call()
