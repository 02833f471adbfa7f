"""The red-black (checkerboard Gauss-Seidel) sweep order of the port against
the JAX engine's.

A red-black sweep is two half-steps: the interior's red sites (``row + col``
even) from the current state, then its black sites from the red half's
state, so each kernel launches twice a sweep; energy and the alpha gradient
come from the second half. Shifted-pair toy problems in float64, both
engines from the JAX initial state (passed to the port as numpy arrays).

Tolerances, as in ``test_torch_slice.py`` and ``test_torch_exact.py``: one
sweep at 1e-10 relative, from the initial state and from a state five
sweeps on; the 30-sweep segment at 1e-8. Two measured properties set where
they apply:

* the exact path's node sums, at the |rho| clamp, differ by ~1e-9 between
  any two f64 summation orders (``test_torch_exact.py``), and the red half's
  correlations carry that into the black half: ``full_mixture``'s warm
  state is taken at ``corr_tor = 0.99`` (ROADMAP Queue 3, P1), while
  ``tpu_fast``'s sits at the clamp;
* with the flagship step (0.1) the red-black order is chaotic on the toy
  even at ``corr_tor = 0.99`` or 0.9: two f64 summation orders separate
  from 1e-15 to 5e-7 in the means over 30 sweeps (Jacobi: 1e-12). At
  ``step0 = 0.03, corr_tor = 0.95`` (:data:`STABLE`, as in
  ``test_torch_exact.py``) they stay within 1e-15 over 60 sweeps, so the
  segment runs there.

The mirrors of the JAX package's own
red-black tests (``tests/test_solver.py``) keep their tolerances: red-black
equal to Jacobi at 1e-12 when the sites are uncoupled, the red half equal to
Jacobi's update at 1e-12, the frozen border exactly frozen.
"""

import jax
import numpy as np
import pytest

from _torch_common import (assert_close, assert_fields_close, port_problem, port_state,
                           shifted_pair)
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.models import gqmap as pg

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
STATE = ("muu", "muv", "sigmau", "sigmav", "pn", "rou")
FR = (-2.0, 2.0, -2.0, 2.0)
CFG = dict(K=5, its=60, eval_every=30, dtype="float64")
# per preset: the toy's cut (the flagship's cosine degrees cut to 16x8)
PRESETS = {"tpu_fast": dict(cheb_p=16, cheb_q=8, L=3), "full_mixture": dict(L=3)}
WARM = {"tpu_fast": {}, "full_mixture": dict(corr_tor=0.99)}  # see the module docstring
STABLE = dict(step0=0.03, corr_tor=0.95)


def _cfgs(preset, **kw):
    kw = {**CFG, **PRESETS[preset], "sweep_order": "redblack", **kw}
    return (getattr(gqmap_tpu.GQMAPConfig, preset)(**kw),
            getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw))


def _exact_problem(jp):
    return problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                   interior=np.asarray(jp.interior), rng=tuple(jp.rng),
                                   cheb=None), device="cpu")


@pytest.fixture(scope="module")
def toy():
    I1, I2, gt = shifted_pair()
    fr = gqmap_tpu.FlowRange(*FR)
    out = dict(I1=I1, I2=I2, gt=gt)
    for preset in PRESETS:
        jc, _ = _cfgs(preset)
        jp = jg.make_problem(jc, I1, I2, fr)
        pp = port_problem(jp) if jp.cheb is not None else _exact_problem(jp)
        out[preset] = dict(jp=jp, pp=pp, js=jg.init_state(jc, fr, I1.shape),
                           jsweep=jax.jit(jg.make_sweep(jc, I1.shape)))
    return out


@pytest.mark.parametrize("warm", [0, 5])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_one_sweep_matches(toy, preset, warm):
    jc, pc = _cfgs(preset, **WARM[preset]) if warm else _cfgs(preset)
    d = toy[preset]
    jsweep = jax.jit(jg.make_sweep(jc, toy["I1"].shape)) if warm else d["jsweep"]
    js = d["js"]
    for _ in range(warm):
        js, _ = jsweep(d["jp"], js)
    if warm and not WARM[preset]:
        assert np.abs(np.asarray(js.rou)).max() > 0.9999  # at the rho clamp
    j1, jaux = jsweep(d["jp"], js)
    p1, paux = pg.make_sweep(pc, toy["I1"].shape)(d["pp"], port_state(js))
    assert_fields_close(p1, j1, 1e-10, 1e-10, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


def test_segment_matches(toy):
    jc, pc = _cfgs("tpu_fast", **STABLE)
    d = toy["tpu_fast"]
    shape = toy["I1"].shape
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, shape)(d["jp"], d["js"], 30)
    pst, pn, peb, ppb, psb, pstop = pg.make_segment_runner(pc, shape)(
        d["pp"], port_state(d["js"]), 30)
    assert pn == int(jn) == 30 and pstop == bool(jstop) is False
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:30], np.asarray(w)[:30], 1e-8, 0)


def _port_sweep(toy, preset, **kw):
    """One port sweep of ``preset`` from the JAX initial state."""
    _, pc = _cfgs(preset, **kw)
    d = toy[preset]
    return pg.make_sweep(pc, toy["I1"].shape)(d["pp"], port_state(d["js"]))


@pytest.mark.parametrize("preset", list(PRESETS))
def test_redblack_equals_jacobi_when_uncoupled(toy, preset):
    # mirror of tests/test_solver.py::test_redblack_equals_jacobi_when_uncoupled:
    # with lambdas = 0 and T = 0 the edge terms vanish, so each site's update
    # depends on its own state only and the two orders agree
    outs = {order: _port_sweep(toy, preset, lambdas=0.0, sweep_order=order)
            for order in ("jacobi", "redblack")}
    (a, aa), (b, ba) = outs["jacobi"], outs["redblack"]
    for f in STATE:
        assert_close(getattr(b, f), getattr(a, f).numpy(), 1e-12, 1e-12, f)
    assert float(ba.ptdmu) == pytest.approx(float(aa.ptdmu), rel=1e-9)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_redblack_half_steps_are_sequential(toy, preset):
    # mirror of tests/test_solver.py::test_redblack_half_steps_are_sequential:
    # with coupling on, the black half sees the red half's fresh values, so a
    # red-black sweep differs from Jacobi; the red sites' updates equal
    # Jacobi's (both start from the same state); the border stays frozen
    st0 = port_state(toy[preset]["js"])
    stj, _ = _port_sweep(toy, preset, sweep_order="jacobi")
    strb, _ = _port_sweep(toy, preset)
    dj = (stj.muu - st0.muu).numpy()
    drb = (strb.muu - st0.muu).numpy()
    assert np.max(np.abs(dj - drb)) > 1e-12
    M, N = toy["I1"].shape
    red = (np.add.outer(np.arange(M), np.arange(N)) & 1) == 0
    np.testing.assert_allclose(dj[:, red], drb[:, red], rtol=1e-12, atol=1e-14)
    border = np.zeros((M, N), bool)
    border[0] = border[-1] = True
    border[:, 0] = border[:, -1] = True
    for f in STATE:
        d = (getattr(strb, f) - getattr(st0, f)).numpy()
        assert np.abs(d[..., border]).max() == 0.0, f


def test_redblack_converges_on_shifted_pair():
    # mirror of tests/test_solver.py::test_redblack_converges_on_shifted_pair:
    # the checkerboard order clearly beats its initial AEPE on the workload
    # and configuration of the JAX test, over 1200 of its 1500 sweeps (the
    # port's plain exact path takes ~45 ms a red-black sweep on one CPU
    # thread; its trace, read every 100 sweeps, falls under 0.55 of the
    # first AEPE from it = 1100 on)
    I1, I2, gt = shifted_pair(32, 36, seed=3)
    cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(
        K=7, L=1, its=1200, eval_every=300, dtype="float64", step_tau=800.0,
        sweep_order="redblack")
    res = gqmap_tpu_torch.solve(cfg, I1, I2, gt_flow=gt,
                                flow_range=gqmap_tpu_torch.FlowRange(*FR), seed=1,
                                device="cpu")
    assert np.isfinite(res.Energy[:res.iters]).all()
    first = res.AEPE[0]
    assert res.best_aepe < 0.55 * first, (first, res.best_aepe)
