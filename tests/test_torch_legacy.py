"""The legacy solver families of the port against the JAX engine.

The presets ``legacy_v1`` (quadratic node prior toward ``Problem.init_flow``,
truncated-quadratic edges), ``legacy_v2`` (windowed nearest-lookup data
term), ``legacy_v3`` (nearest lookup, Prewitt chain-rule estimator),
``blockmatch_v2`` (nearest lookup at K = 17, from the block-matching init)
and ``tpu_fast(window_rg=2)`` (the cosine term over the window-meaned
potential), and the autodiff estimator, on a shifted pair of 24x28 frames.
Everything runs in float64 and both engines start from the JAX problem and
initial state, passed to the port as numpy arrays
(``gqmap_tpu_torch.convert``). The engine tests cut the presets to K = 5
(and the cosine degrees to 8x4); ``blockmatch_v2`` also runs its own K = 17
once, on a 12x14 pair.

Tolerances, as in ``test_torch_slice.py``: each op at 1e-10 of the output's
largest magnitude (the upsampled tables at 1e-12); one sweep at 1e-10
relative with 1e-12 absolute (``pn`` stays at rounding noise around 0 on
the quadratic prior); 30-sweep segments and solves at 1e-8, the readouts at
1e-7 (logP, AEPE) and 1e-6 absolute (MAP), where two f64 summation orders
stay together (:data:`MULTI`); the block-matching init exactly. Two
properties of the JAX engine itself (ROADMAP Queue 3) are shown on it:
P3, the nearest-lookup presets' trajectories at their own step leave one
another from a one-ulp change of the init, and P4, ``blockmatch_v2`` leaves
the block-matching flow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, assert_fields_close, np_fields, port_state, shifted_pair, t
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import blockmatch as jbm
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import cosine as jcos
from gqmap_tpu.ops import gq as jgq
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops.quadrature import build_table as jax_build_table
from gqmap_tpu.ops.quadrature import build_table_1d as jax_build_table_1d
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import cosine_gq, edge_gq, edge_reduced_gq, nearest_gq
from gqmap_tpu_torch.models import blockmatch
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import cosine, gq, interp, potentials
from gqmap_tpu_torch.ops.quadrature import build_table, build_table_1d

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
FR = (-2.0, 2.0, -2.0, 2.0)
SHAPE = (24, 28)
TOY = dict(K=5, dtype="float64", its=60, eval_every=30)
# (name, preset, overrides): every legacy family, each estimator and both edge rules
CASES = {
    "legacy_v1": ("legacy_v1", {}),
    "legacy_v1 reduced": ("legacy_v1", dict(edge_quad="reduced")),
    "legacy_v2": ("legacy_v2", {}),
    "legacy_v3": ("legacy_v3", {}),
    "blockmatch_v2": ("blockmatch_v2", {}),
    "tpu_fast window": ("tpu_fast", dict(window_rg=2, cheb_p=8, cheb_q=4, cheb_ablock=4)),
    "autodiff tensor": ("legacy_v2", dict(gradient_estimator="autodiff")),
    "autodiff reduced": ("legacy_v2", dict(gradient_estimator="autodiff", edge_quad="reduced")),
    "autodiff cosine": ("tpu_fast", dict(gradient_estimator="autodiff", cheb_p=8, cheb_q=4,
                                         cheb_ablock=2)),
}
KERNELS = (cosine_gq.cos_mode_sums_cuda, edge_reduced_gq.edge_reduced_grads_cuda,
           edge_gq.edge_gq_cuda, nearest_gq.nearest_gq_cuda, nearest_gq.nearest_chain_gq_cuda)


def _cfgs(preset, **kw):
    kw = {**TOY, **kw}
    return (getattr(gqmap_tpu.GQMAPConfig, preset)(**kw),
            getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw))


def _init_flow(shape=SHAPE):
    flow = np.zeros(shape + (2,))
    flow[..., 0] = 1.25
    return flow


def _port_problem(jp):
    return problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab), interior=np.asarray(jp.interior),
        rng=tuple(jp.rng), cheb=None if jp.cheb is None else np_fields(jp.cheb),
        init_flow=None if jp.init_flow is None else np.asarray(jp.init_flow),
        grad_tabs=None if jp.grad_tabs is None else [np.asarray(g) for g in jp.grad_tabs]),
        device="cpu")


def _problems(jc, I1, I2):
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    if jc.data_term == "quadratic":
        jp = jp._replace(init_flow=jnp.asarray(_init_flow(I1.shape)))
    return jp, _port_problem(jp)


@pytest.fixture(scope="module")
def toy():
    I1, I2, gt = shifted_pair(*SHAPE)
    return dict(I1=I1, I2=I2, gt=gt)


def _sites(seed, shape=SHAPE, lead=(3, 1), sig=(0.2, 1.5), rho=0.9):
    r = np.random.default_rng(seed)
    return (r.uniform(-2, 2, shape), r.uniform(-2, 2, shape), r.uniform(*sig, shape),
            r.uniform(*sig, shape), r.uniform(-rho, rho, shape),
            r.uniform(-2, 2, lead + shape), r.uniform(-2, 2, lead + shape))


def _close_rel(got, want, name="", tol=1e-10):
    w = np.asarray(want)
    assert got.shape == w.shape, (name, tuple(got.shape), w.shape)
    assert_close(got, w, 0, tol * max(np.abs(w).max(), 1e-300), name)


# --- ops/interp ---------------------------------------------------------------

@pytest.mark.parametrize("rfc", [4, 6])
def test_upsample_cubic_matches(toy, rfc):
    want = jinterp.upsample_cubic(jnp.asarray(toy["I2"]), rfc)
    got = interp.upsample_cubic(t(toy["I2"]), rfc)
    assert got.shape == ((SHAPE[0] - 1) * 2 ** rfc + 1, (SHAPE[1] - 1) * 2 ** rfc + 1)
    _close_rel(got, want, "upsample", 1e-12)
    # the refined grid holds the frame's own values at every 2^rfc-th node
    assert torch.equal(got[::2 ** rfc, ::2 ** rfc], t(toy["I2"]))


def test_prewitt_and_interp2_cubic_match(toy):
    V = toy["I2"]
    for g, w in zip(interp.prewitt_gradients(t(V)), jinterp.prewitt_gradients(jnp.asarray(V))):
        _close_rel(g, w, "prewitt")
    # exact on a linear ramp (tests/test_legacy_modes.py)
    yy, xx = np.mgrid[0:12, 0:15].astype(float)
    Gx, Gy = interp.prewitt_gradients(t(3.0 * xx - 2.0 * yy + 7.0))
    assert_close(Gx[1:-1, 1:-1], np.full((10, 13), 3.0), 1e-12, 0)
    assert_close(Gy[1:-1, 1:-1], np.full((10, 13), -2.0), 1e-12, 0)
    r = np.random.default_rng(4)
    Xq, Yq = r.uniform(1, SHAPE[1], (5, 6)), r.uniform(1, SHAPE[0], (5, 6))
    _close_rel(interp.interp2_cubic(t(V), t(Xq), t(Yq)),
               jinterp.interp2_cubic(jnp.asarray(V), jnp.asarray(Xq), jnp.asarray(Yq)), "interp2")


# --- ops/potentials ------------------------------------------------------------

def _node_pots(I1, I2, rfc=4):
    """(name, JAX potential, port potential) of every legacy node term."""
    tab_j = jinterp.upsample_cubic(jnp.asarray(I2), rfc)
    VV_j = jinterp.pad_cubic(jnp.asarray(I2))
    I1j, tab, VV = jnp.asarray(I1), t(np.asarray(tab_j)), t(np.asarray(VV_j))
    flow = _init_flow(I1.shape) + np.random.default_rng(9).normal(size=I1.shape + (2,))
    return [
        ("nearest", jpot.make_node_pot_nearest(I1j, tab_j, 0.3, 1e-4, rfc),
         potentials.make_node_pot_nearest(t(I1), tab, 0.3, 1e-4, rfc)),
        ("windowed nearest", jpot.make_node_pot_windowed(I1j, tab_j, 1.0, 1e-4, 2, "nearest", rfc),
         potentials.make_node_pot_windowed(t(I1), tab, 1.0, 1e-4, 2, "nearest", rfc)),
        ("windowed bicubic", jpot.make_node_pot_windowed(I1j, VV_j, 1.0, 1e-6, 1, "bicubic"),
         potentials.make_node_pot_windowed(t(I1), VV, 1.0, 1e-6, 1, "bicubic")),
        ("quadratic", jpot.make_node_pot_quadratic(jnp.asarray(flow), 0.05),
         potentials.make_node_pot_quadratic(t(flow), 0.05)),
    ]


def test_node_potentials_match(toy):
    *_, x1, x2 = _sites(5)
    for name, fj, fp in _node_pots(toy["I1"], toy["I2"]):
        _close_rel(fp(t(x1), t(x2)), fj(jnp.asarray(x1), jnp.asarray(x2)), name)


def test_nearest_chain_potential_matches(toy):
    *_, x1, x2 = _sites(6)
    I2j = jnp.asarray(toy["I2"])
    tabs_j = [jinterp.upsample_cubic(x, 4) for x in (I2j, *jinterp.prewitt_gradients(I2j))]
    fj = jpot.make_node_pot_nearest_chain(jnp.asarray(toy["I1"]), *tabs_j, 1.0, 1e-4, 4)
    fp = potentials.make_node_pot_nearest_chain(t(toy["I1"]), *(t(np.asarray(x)) for x in tabs_j),
                                                1.0, 1e-4, 4)
    for k, (g, w) in enumerate(zip(fp(t(x1), t(x2)), fj(jnp.asarray(x1), jnp.asarray(x2)))):
        _close_rel(g, w, f"output {k}")


def test_truncquad_edge_potentials_match():
    r = np.random.default_rng(7)
    x1, x2 = r.uniform(-15, 15, (4, 50)), r.uniform(-15, 15, (4, 50))
    want = jpot.make_edge_pot_truncquad(1.3, 10.0)(jnp.asarray(x1), jnp.asarray(x2))
    got = potentials.make_edge_pot_truncquad(1.3, 10.0)(t(x1), t(x2))
    _close_rel(got, want, "truncquad")
    assert bool((got == 0).any()) and bool((got != 0).any())  # both sides of the cutoff
    want = jpot.make_edge_pot_truncquad_diff(1.3, 10.0)(jnp.asarray(x1 - x2))
    _close_rel(potentials.make_edge_pot_truncquad_diff(1.3, 10.0)(t(x1 - x2)), want, "diff")


# --- ops/gq ----------------------------------------------------------------------

def test_chain_sums_and_finalize_chain_match(toy):
    u1, u2, o1, o2, p, _, _ = _sites(8, lead=())
    I2j = jnp.asarray(toy["I2"])
    tabs_j = [jinterp.upsample_cubic(x, 6) for x in (I2j, *jinterp.prewitt_gradients(I2j))]
    fj = jpot.make_node_pot_nearest_chain(jnp.asarray(toy["I1"]), *tabs_j, 1.0, 1e-4, 6)
    fp = potentials.make_node_pot_nearest_chain(t(toy["I1"]), *(t(np.asarray(x)) for x in tabs_j),
                                                1.0, 1e-4, 6)
    site = [jnp.asarray(x) for x in (u1, u2, o1, o2, p)]
    want = jgq.gq_accumulate_chain(fj, *site, jax_build_table(5, 7, np.float64))
    got = gq.gq_accumulate_chain(fp, *map(t, (u1, u2, o1, o2, p)), build_table(5, 7, np.float64))
    for name in want._fields:
        _close_rel(getattr(got, name), getattr(want, name), name)
    a = np.array([0.7])
    wf = jgq.finalize_chain(want, jnp.asarray(a), site[2], site[3], site[4], 0.2, jgq.NODE)
    gf = gq.finalize_chain(got, t(a), t(o1), t(o2), t(p), 0.2, gq.NODE)
    for name in wf._fields:
        _close_rel(getattr(gf, name), getattr(wf, name), name)


def test_expectations_match(toy):
    u1, u2, o1, o2, p, _, _ = _sites(10, lead=())
    site = [jnp.asarray(x) for x in (u1, u2, o1, o2, p)]
    tsite = list(map(t, (u1, u2, o1, o2, p)))
    (_, fj, fp), = [x for x in _node_pots(toy["I1"], toy["I2"]) if x[0] == "nearest"]
    for chunk in (0, 7):
        _close_rel(gq.gq_ei(fp, *tsite, build_table(5, chunk, np.float64)),
                   jgq.gq_ei(fj, *site, jax_build_table(5, chunk, np.float64)), "gq_ei")
    _close_rel(gq.gq_expectation(fp, *tsite, build_table(5, 0, np.float64)),
               jgq.gq_expectation(fj, *site, jax_build_table(5, 0, np.float64)), "expectation")
    for gdj, gdp in ((jpot.make_edge_pot_diff(5.0, 1e-6), potentials.make_edge_pot_diff(5.0, 1e-6)),
                     (jpot.make_edge_pot_truncquad_diff(1.0, 1.0),
                      potentials.make_edge_pot_truncquad_diff(1.0, 1.0))):
        _close_rel(gq.gq_ei_diff(gdp, *tsite, build_table_1d(13, dtype=np.float64)),
                   jgq.gq_ei_diff(gdj, *site, jax_build_table_1d(13, dtype=np.float64)), "ei_diff")


# --- ops/cosine ------------------------------------------------------------------

def test_box_mean_and_windowed_cos_data_match(toy):
    r = np.random.default_rng(12)
    npt = r.normal(size=SHAPE)
    _close_rel(cosine._box_mean(t(npt), 2), jcos._box_mean(jnp.asarray(npt), 2), "box mean")
    # a leading batch of surfaces is filtered surface by surface
    batch = r.normal(size=(3,) + SHAPE)
    got = cosine._box_mean(t(batch), 1)
    for k in range(3):
        _close_rel(got[k], jcos._box_mean(jnp.asarray(batch[k]), 1), f"box mean {k}")
    VV = jinterp.pad_cubic(jnp.asarray(toy["I2"]))
    box = (-3.0, 2.5, -1.5, 1.5)
    want = jcos.build_cos_data(jnp.asarray(toy["I1"]), VV, 1.0, 1e-6, box, A=16, B=8,
                               window_rg=2)
    got = cosine.build_cos_data(t(toy["I1"]), t(np.asarray(VV)), 1.0, 1e-6, box, A=16, B=8,
                                window_rg=2)
    _close_rel(got.coeffs, want.coeffs, "coeffs", 1e-12)


def test_cos_ei_and_its_gradient_match(toy):
    VV = jinterp.pad_cubic(jnp.asarray(toy["I2"]))
    jc = jcos.build_cos_data(jnp.asarray(toy["I1"]), VV, 1.0, 1e-6, (-3.0, 3.0, -3.0, 3.0),
                             A=8, B=4, window_rg=1)
    pc = cosine.CosData(t(np.asarray(jc.coeffs)), float(jc.lo_u), float(jc.hi_u),
                        float(jc.lo_v), float(jc.hi_v))
    site = _sites(13, shape=(2,) + SHAPE)[:5]
    want = jcos.cos_ei(jc, *map(jnp.asarray, site), a_block=2)
    weights = np.random.default_rng(14).normal(size=np.shape(want))
    wgrads = jax.grad(lambda *x: jnp.sum(jnp.asarray(weights) * jcos.cos_ei(jc, *x, a_block=2)),
                      argnums=tuple(range(5)))(*map(jnp.asarray, site))
    leaves = [t(x).requires_grad_() for x in site]
    got = cosine.cos_ei(pc, *leaves)
    _close_rel(got.detach(), want, "cos_ei")
    ggrads = torch.autograd.grad((t(weights) * got).sum(), leaves)
    for k, (g, w) in enumerate(zip(ggrads, wgrads)):
        _close_rel(g, w, f"d/d(arg {k})")


# --- models/blockmatch ----------------------------------------------------------

def test_block_matching_init_equals_jax_exactly(toy):
    want = jbm.block_matching_init(toy["I1"], toy["I2"], U=3, V=3, ft=2, sigma=1.2)
    got = blockmatch.block_matching_init(toy["I1"], toy["I2"], U=3, V=3, ft=2, sigma=1.2,
                                         device="cpu")
    assert got.dtype == np.float32 and got.shape == SHAPE + (2,)
    np.testing.assert_array_equal(got, want)
    assert (got[4:-4, 4:-4] == [1.0, 0.0]).all()  # the pair's shift, away from the border
    np.testing.assert_array_equal(blockmatch.gaussian_window(7, 1.7), jbm.gaussian_window(7, 1.7))


# --- the engine -------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_one_sweep_matches(toy, case):
    preset, kw = CASES[case]
    jc, pc = _cfgs(preset, **kw)
    jp, pp = _problems(jc, toy["I1"], toy["I2"])
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE)
    j1, jaux = jax.jit(jg.make_sweep(jc, SHAPE))(jp, js)
    p1, paux = pg.make_sweep(pc, SHAPE)(pp, port_state(js))
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


def test_blockmatch_v2_sweep_at_its_own_k17_matches():
    # the preset's own K = 17 (289-point rules: K3's plain version at K = 17
    # on the edges, the nearest lookup's node quadrature), from the
    # block-matching init
    I1, I2, gt = shifted_pair(12, 14)
    kw = dict(dtype="float64", its=2, eval_every=2)
    jc, pc = (pkg.GQMAPConfig.blockmatch_v2(**kw) for pkg in (gqmap_tpu, gqmap_tpu_torch))
    assert pc.K == 17
    jp, pp = _problems(jc, I1, I2)
    flow = blockmatch.block_matching_init(I1, I2, U=2, V=2, ft=1, device="cpu")
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), I1.shape)
    js = js._replace(muu=jnp.asarray(np.clip(flow[..., 0], -2, 2), jnp.float64)[None],
                     muv=jnp.asarray(np.clip(flow[..., 1], -2, 2), jnp.float64)[None])
    j1, jaux = jax.jit(jg.make_sweep(jc, I1.shape))(jp, js)
    p1, paux = pg.make_sweep(pc, I1.shape)(pp, port_state(js))
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


# Multi-sweep parity runs where two f64 summation orders stay together: at
# the corr_tor = 0.99 of the other paths (ROADMAP Queue 3, P1), except for
# the nearest-lookup presets, whose trajectories at the presets' step
# separate ~3x a sweep on the toy (1e-16 to 1e-2 over 30 sweeps of
# legacy_v2; Queue 3, P3) and stay within 1e-9 at step0 = 0.03,
# corr_tor = 0.95, as the red-black tests run (P2).
CALM = dict(step0=0.03, corr_tor=0.95)
MULTI = {"legacy_v1": dict(corr_tor=0.99), "tpu_fast window": dict(corr_tor=0.99),
         "legacy_v2": CALM, "legacy_v3": CALM, "autodiff reduced": CALM}


@pytest.mark.parametrize("case", list(MULTI))
def test_segment_matches(toy, case):
    preset, kw = CASES[case]
    jc, pc = _cfgs(preset, tor=0.0, **MULTI[case], **kw)
    jp, pp = _problems(jc, toy["I1"], toy["I2"])
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE)
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, SHAPE)(jp, js, 30)
    pst, pn, peb, ppb, psb, pstop = pg.make_segment_runner(pc, SHAPE)(pp, port_state(js), 30)
    assert pn == int(jn) == 30 and pstop == bool(jstop) is False
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:30], np.asarray(w)[:30], 1e-8, 0)


def _solves(jc, pc, toy, js):
    jr = jg.solve(jc, toy["I1"], toy["I2"], gt_flow=toy["gt"], init=js,
                  flow_range=gqmap_tpu.FlowRange(*FR))
    pr = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                               init=port_state(js),
                               flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    return jr, pr


def _assert_solves_close(pr, jr, its):
    assert pr.iters == jr.iters == its and pr.map.shape == SHAPE + (2,)
    evals = [i for i in range(its) if np.isfinite(jr.AEPE[i])]
    assert evals == [i for i in range(its) if np.isfinite(pr.AEPE[i])]
    assert_close(pr.AEPE[evals], jr.AEPE[evals], 1e-7, 0, "AEPE")
    assert_close(pr.logP[evals], jr.logP[evals], 1e-7, 0, "logP")
    assert_close(pr.Energy, jr.Energy, 1e-8, 0, "Energy")
    assert_close(pr.map, jr.map, 0, 1e-6, "map")
    assert abs(pr.best_aepe - jr.best_aepe) <= 1e-7 * jr.best_aepe
    for name in ("mu", "sigma", "alpha"):
        assert_close(getattr(pr, name), getattr(jr, name), 1e-8, 1e-8, name)
    return evals


@pytest.mark.parametrize("preset", ["legacy_v2", "legacy_v3"])
def test_solve_matches(toy, preset):
    jc, pc = _cfgs(preset, its=30, eval_every=15, tor=0.0, **CALM)
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE)
    jr, pr = _solves(jc, pc, toy, js)
    evals = _assert_solves_close(pr, jr, 30)
    assert evals == [0, 14, 29]
    assert pr.AEPE[29] < pr.AEPE[0]  # from the random init the AEPE falls


def _blockmatch_solves(toy, step):
    """60-sweep ``blockmatch_v2`` solves of both engines at ``step``, from
    the block-matching init and from the random init it replaces:
    ``((jax, port) from block matching, (jax, port) from random)``."""
    flow = blockmatch.block_matching_init(toy["I1"], toy["I2"], U=3, V=3, ft=2, device="cpu")
    assert (flow[4:-4, 4:-4] == [1.0, 0.0]).all()
    jc, pc = _cfgs("blockmatch_v2", its=60, eval_every=10, tor=0.0, **step)
    js0 = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE)
    js = js0._replace(**{f: jnp.broadcast_to(jnp.clip(jnp.asarray(flow[..., k], jnp.float64),
                                                      -2.0, 2.0)[None], js0.muu.shape)
                         for k, f in enumerate(("muu", "muv"))})
    return _solves(jc, pc, toy, js), _solves(jc, pc, toy, js0)


def test_blockmatch_v2_from_block_matching_init_matches_and_leaves_it(toy):
    # ROADMAP Queue 3, P4: from the block-matching flow, right at it = 1 on
    # the shifted pair, the preset's wide sigma init carries the means off
    # it. Both engines do so, together at CALM; at the preset's own step
    # they separate (P3) but each one's AEPE still rises, while from the
    # random init it falls
    for step in (CALM, {}):
        (jr, pr), (jrand, prand) = _blockmatch_solves(toy, step)
        if step:
            _assert_solves_close(pr, jr, 60)
            _assert_solves_close(prand, jrand, 60)
        for r, rand in ((jr, jrand), (pr, prand)):
            assert r.AEPE[0] < 0.15 and r.AEPE[59] > 2.0 * r.AEPE[0]
            assert rand.AEPE[59] < rand.AEPE[0]


_F6 = ("muu", "muv", "sigmau", "sigmav", "pn", "rou")


def _separation(a, b):
    return max(float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())
               for f in _F6)


def _lookup_index(st, cfg, tab_shape):
    """The flat table index of every node-quadrature sample at ``st``."""
    index = potentials._nearest_index(tab_shape, cfg.rfc)
    ii, jj = (torch.arange(1, n + 1, dtype=torch.float64) for n in SHAPE)
    ii, jj = torch.meshgrid(ii, jj, indexing="ij")
    tab = build_table(cfg.K, cfg.quad_chunk, np.float64)
    return torch.cat([index(jj + x1, ii + x2).reshape(-1) for *_, x1, x2 in
                      gq._whitened_steps(st.muu, st.muv, st.sigmau, st.sigmav, st.pn, tab)])


@pytest.mark.parametrize("preset", ["legacy_v2", "legacy_v3"])
def test_nearest_lookup_presets_separate_from_themselves(toy, preset):
    # ROADMAP Queue 3, P3, from the JAX engine alone: its trajectory from an
    # init moved by one ulp in every field leaves the unmoved one at the
    # presets' step (corr_tor = 0.99) as fast as the port's does, and both
    # stay together at CALM. The separation grows smoothly: no lookup index
    # of the node quadrature differs between the port and JAX before the two
    # are 1e-6 apart, so a flipped nearest lookup does not start it
    for step in (dict(corr_tor=0.99), CALM):
        seen = _separations(preset, step)
        for _, _, flips, before in seen:
            assert flips == 0 or before > 1e-6
        if step is CALM:
            assert max(max(x[:2]) for x in seen) < 1e-10
        else:
            assert seen[0][0] < 1e-14 and seen[0][1] < 1e-14
            assert seen[-1][0] > 1e-6 and seen[-1][1] > 1e-6


def _separations(preset, step, seed=0, n=30, **kw):
    """``n`` sweeps of JAX, of JAX from the init moved by one ulp in every
    field, and of the port, on the shifted pair of seed ``seed`` from the
    JAX init of that seed: for each sweep (JAX moved - JAX, port - JAX) after
    it, and the node lookups that differ between the port and JAX before it,
    with their separation then."""
    I1, I2, _ = shifted_pair(*SHAPE, seed=seed)
    jc, pc = _cfgs(preset, tor=0.0, **step, **kw)
    jp, pp = _problems(jc, I1, I2)
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE, seed=seed)
    jmoved = js._replace(**{f: jnp.nextafter(getattr(js, f), jnp.inf) for f in _F6})
    jsweep, psweep = jax.jit(jg.make_sweep(jc, SHAPE)), pg.make_sweep(pc, SHAPE)
    ps, seen = port_state(js), []
    for _ in range(n):
        flips = int((_lookup_index(ps, pc, pp.I2_tab.shape)
                     != _lookup_index(port_state(js), pc, pp.I2_tab.shape)).sum())
        before = _separation(ps, js)
        js, jmoved, ps = jsweep(jp, js)[0], jsweep(jp, jmoved)[0], psweep(pp, ps)[0]
        seen.append((_separation(jmoved, js), _separation(ps, js), flips, before))
    return seen


@pytest.mark.parametrize("case", ["legacy_v2", "legacy_v3", "legacy_v1", "tpu_fast window"])
def test_logp_matches(toy, case):
    # logP through the sweep's own point potential: nearest lookup (windowed
    # for legacy_v2), the windowed bicubic term in place of the windowed
    # cosine series, the bicubic term in place of the quadratic prior
    preset, kw = CASES[case]
    jc, pc = _cfgs(preset, **kw)
    jp, pp = _problems(jc, toy["I1"], toy["I2"])
    flow = np.random.default_rng(3).uniform(-2, 2, SHAPE + (2,))
    want = jg.make_logp_fn(jc, SHAPE)(jp, jnp.asarray(flow))
    got = pg.make_logp_fn(pc, SHAPE)(pp, t(flow))
    assert_close(got, want, 1e-10, 0, f"logP {case}")


def test_legacy_v1_means_track_the_prior(toy):
    # mirror of tests/test_solver.py::test_legacy_v1_quadratic_family: with a
    # dominant prior the interior means track the init flow
    _, pc = _cfgs("legacy_v1", its=300, quad_var=0.05)
    pp = pg.make_problem(pc, toy["I1"], toy["I2"], gqmap_tpu_torch.FlowRange(*FR),
                         device="cpu")._replace(init_flow=t(_init_flow()))
    st = pg.init_state(pc, gqmap_tpu_torch.FlowRange(*FR), SHAPE, device="cpu")
    st, n, *_ = pg.make_segment_runner(pc, SHAPE)(pp, st, 300)
    assert abs(float(st.muu[0, 1:-1, 1:-1].median()) - 1.25) < 0.15


def test_solve_does_not_set_the_quadratic_prior(toy):
    # solve(init_flow=...) seeds the means only, as the JAX solve does
    # (ROADMAP Queue 3, F4): legacy_v1 needs Problem.init_flow
    _, pc = _cfgs("legacy_v1", its=2)
    with pytest.raises(ValueError, match="Problem.init_flow"):
        gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                              init_flow=_init_flow(), device="cpu")


def test_legacy_make_problem_value_errors(toy):
    for kw, match in ((dict(data_term="bicubic"), "requires data_term='nearest'"),
                      (dict(window_rg=1, patch=4), "mutually exclusive")):
        jc, pc = _cfgs("legacy_v3", **kw)
        with pytest.raises(ValueError, match=match):
            jg.make_problem(jc, toy["I1"], toy["I2"], gqmap_tpu.FlowRange(*FR))
        with pytest.raises(ValueError, match=match):
            pg.make_problem(pc, toy["I1"], toy["I2"], gqmap_tpu_torch.FlowRange(*FR),
                            device="cpu")


def test_problem_carries_legacy_tables(toy):
    jc, pc = _cfgs("legacy_v3")
    jp, pp = _problems(jc, toy["I1"], toy["I2"])
    own = pg.make_problem(pc, toy["I1"], toy["I2"], gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    assert own.I2_tab.shape == (23 * 16 + 1, 27 * 16 + 1) and own.init_flow is None
    for g, w in zip((own.I2_tab, *own.grad_tabs), (jp.I2_tab, *jp.grad_tabs)):
        _close_rel(g, w, "table", 1e-12)
    assert len(pp.grad_tabs) == 2 and pp.cheb is None


def test_cpu_runs_launch_no_kernel(toy):
    before = [k.launches for k in KERNELS]
    for preset, kw in CASES.values():
        if preset == "legacy_v1":
            continue  # needs Problem.init_flow: covered by the segment tests
        _, pc = _cfgs(preset, its=2, eval_every=2, **kw)
        res = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                    flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
        assert res.iters == 2 and np.isfinite(res.Energy).all()
    assert [k.launches for k in KERNELS] == before == [0] * 5


if __name__ == "__main__":
    # The numbers of ROADMAP Queue 3, P3 and P4:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_legacy.py
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    for preset, kw in (("legacy_v2", {}), ("legacy_v3", {}),
                       ("legacy_v2", dict(gradient_estimator="autodiff", edge_quad="reduced"))):
        for seed in (0, 1):
            at = {}
            for name, step in (("preset", dict(corr_tor=0.99)), ("CALM", CALM)):
                seen = _separations(preset, step, seed, **kw)
                first = next(((k, x[3]) for k, x in enumerate(seen) if x[2]), None)
                at[name] = (f"after 30: JAX-JAX {seen[-1][0]:.1e}, port-JAX {seen[-1][1]:.1e}; "
                            f"largest {max(max(x[:2]) for x in seen):.1e}; first lookup flip "
                            + ("none" if first is None else
                               f"before sweep {first[0] + 1}, {first[1]:.1e} apart"))
            print(f"P3 {preset} {kw} seed {seed}: " + "; ".join(f"{k}: {v}" for k, v in at.items()))
    I1, I2, gt = shifted_pair(*SHAPE)
    for name, step in (("CALM", CALM), ("preset", {})):
        for init, (jr, pr) in zip(("block matching", "random"),
                                  _blockmatch_solves(dict(I1=I1, I2=I2, gt=gt), step)):
            for engine, r in (("JAX", jr), ("port", pr)):
                print(f"P4 blockmatch_v2 at {name} step from {init} init, {engine}: AEPE "
                      f"{r.AEPE[0]:.4f} at it = 1 -> {r.AEPE[59]:.4f} at it = 60")
