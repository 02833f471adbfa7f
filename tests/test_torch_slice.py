"""The port's main path (``tpu_fast``) against the JAX engine, end to end.

A shifted-pair toy problem (24x28, K=5, cosine degrees 16x8, L=3) in
float64. Both engines start from the JAX problem and initial state, passed
to the port through ``gqmap_tpu_torch.convert`` (``jax.random`` and
``torch.Generator`` give different bits).

Tolerances:
* one sweep: 1e-10 relative, also from a state whose edge correlations sit
  at the |rho| clamp (1 - 1e-5), where 1/(1-rho^2) ~ 5e4 amplifies round-off;
* multi-sweep runs use ``corr_tor=0.99``: with the flagship clamp the
  f64 trajectories of any two summation orders separate by ~1.5x per sweep
  once rho reaches the clamp (measured: 3e-6 after 30 sweeps, 0.2 after
  60), while at 0.99 they agree to 1e-9 over 60 sweeps; 30-sweep states are
  compared at 1e-8, the readouts at 1e-7 (logP, AEPE) and 1e-6 absolute
  (MAP), because the golden-section MAP search resolves each mode only to
  ~sqrt(eps) * sigma, where the pdf values it compares are equal in f64.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, assert_fields_close, port_problem, port_state,
                           shifted_pair, t)
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu_torch.kernels.cosine_gq import cos_mode_sums_cuda
from gqmap_tpu_torch.kernels.edge_reduced_gq import edge_reduced_grads_cuda
from gqmap_tpu_torch.models import gqmap as pg

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
FR = (-2.0, 2.0, -2.0, 2.0)
TOY = dict(K=5, cheb_p=16, cheb_q=8, L=3, dtype="float64", its=60, eval_every=30)
VARIANTS = {
    "flagship": {},
    # alpha update from sweep 6 and annealing every 10 sweeps from T=0.2
    "alpha_anneal": dict(alpha_start=5, temperature=0.2, anneal_every=10),
}


def _cfgs(**kw):
    kw = {**TOY, **kw}
    return gqmap_tpu.GQMAPConfig.tpu_fast(**kw), gqmap_tpu_torch.GQMAPConfig.tpu_fast(**kw)


@pytest.fixture(scope="module")
def toy():
    I1, I2, gt = shifted_pair()
    jc, _ = _cfgs()
    fr = gqmap_tpu.FlowRange(*FR)
    jp = jg.make_problem(jc, I1, I2, fr)
    js = jg.init_state(jc, fr, I1.shape)
    return dict(I1=I1, I2=I2, gt=gt, jp=jp, js=js, pp=port_problem(jp),
                jsweep=jax.jit(jg.make_sweep(jc, I1.shape)))


def test_make_problem_matches(toy):
    _, pc = _cfgs()
    pp = pg.make_problem(pc, toy["I1"], toy["I2"], gqmap_tpu_torch.FlowRange(*FR),
                         device="cpu")
    jp = toy["jp"]
    for name in ("I1", "I2_tab", "interior"):
        assert_close(getattr(pp, name), getattr(jp, name), 1e-12, 0, name)
    want = np.asarray(jp.cheb.coeffs)
    assert_close(pp.cheb.coeffs, want, 0, 1e-12 * np.abs(want).max(), "coeffs")


@pytest.mark.parametrize("warm", [0, 20])
def test_one_sweep_matches(toy, warm):
    _, pc = _cfgs()
    jsweep = toy["jsweep"]
    js = toy["js"]
    for _ in range(warm):
        js, _ = jsweep(toy["jp"], js)
    if warm:
        assert np.abs(np.asarray(js.rou)).max() > 0.9999  # at the rho clamp
    j1, jaux = jsweep(toy["jp"], js)
    p1, paux = pg.make_sweep(pc, toy["I1"].shape)(toy["pp"], port_state(js))
    assert_fields_close(p1, j1, 1e-10, 1e-10, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_segment_matches(toy, variant):
    jc, pc = _cfgs(corr_tor=0.99, **VARIANTS[variant])
    shape = toy["I1"].shape
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, shape)(toy["jp"], toy["js"], 30)
    pst, pn, peb, ppb, psb, pstop = pg.make_segment_runner(pc, shape)(
        toy["pp"], port_state(toy["js"]), 30)
    assert pn == int(jn) == 30 and pstop == bool(jstop) is False
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:30], np.asarray(w)[:30], 1e-8, 0)


@pytest.mark.parametrize("override, n_done", [(dict(tor=1e9), 1), (dict(its=4), 4)])
def test_segment_early_stop(toy, override, n_done):
    # the reference's stop rule, checked after every sweep: tor above every
    # mean |dmu| stops after the first sweep, its=4 after the fourth
    _, pc = _cfgs(**override)
    state, n, eb, _, _, stop = pg.make_segment_runner(pc, toy["I1"].shape)(
        toy["pp"], port_state(toy["js"]), 30)
    assert n == n_done and stop is True and int(state.it) == n_done + 1
    assert torch.isfinite(eb[:n]).all() and not eb[n:].any()
    j1, _ = toy["jsweep"](toy["jp"], toy["js"])
    if n_done == 1:
        assert_fields_close(state, j1, 1e-10, 1e-10, FIELDS)


def test_solve_matches(toy):
    jc, pc = _cfgs(corr_tor=0.99)
    jr = jg.solve(jc, toy["I1"], toy["I2"], gt_flow=toy["gt"], init=toy["js"],
                  flow_range=gqmap_tpu.FlowRange(*FR))
    pr = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                               init=port_state(toy["js"]),
                               flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    assert pr.iters == jr.iters == 60
    evals = [0, 29, 59]
    assert np.isnan(pr.AEPE[10]) and np.isnan(pr.logP[10])
    assert_close(pr.AEPE[evals], jr.AEPE[evals], 1e-7, 0, "AEPE")
    assert_close(pr.logP[evals], jr.logP[evals], 1e-7, 0, "logP")
    assert_close(pr.Energy, jr.Energy, 1e-8, 0, "Energy")
    assert_close(pr.map, jr.map, 0, 1e-6, "map")
    assert abs(pr.best_aepe - jr.best_aepe) <= 1e-7 * jr.best_aepe
    for name in ("mu", "sigma", "alpha"):
        assert_close(getattr(pr, name), getattr(jr, name), 1e-8, 1e-8, name)
    # the solver optimizes: AEPE falls from the random init
    assert pr.AEPE[59] < pr.AEPE[0]


def test_readouts_match(toy):
    jc, pc = _cfgs()
    shape = toy["I1"].shape
    r = np.random.default_rng(3)
    flow = r.uniform(-2, 2, shape + (2,))
    want = jg.make_logp_fn(jc, shape)(toy["jp"], flow)
    got = pg.make_logp_fn(pc, shape)(toy["pp"], t(flow))
    assert_close(got, want, 1e-10, 0, "logP")
    unknown = r.uniform(size=shape) < 0.1
    assert pg.aepe_of(pc, flow, toy["gt"], unknown) == pytest.approx(
        jg.aepe_of(jc, flow, toy["gt"], unknown), rel=1e-12)
    assert_close(pg.make_map_fn(pc)(port_state(toy["js"])), jg.make_map_fn(jc)(toy["js"]),
                 0, 1e-6, "map")


def test_cpu_run_launches_no_kernel(toy):
    _, pc = _cfgs(its=3)
    res = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    assert cos_mode_sums_cuda.launches == 0
    assert edge_reduced_grads_cuda.launches == 0
    # the explicit kernel route refuses CPU tensors instead of falling back
    _, cuda_cfg = _cfgs(node_kernel="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.make_sweep(cuda_cfg, toy["I1"].shape)(toy["pp"], port_state(toy["js"]))


def test_port_init_state_is_seeded_and_in_range():
    _, pc = _cfgs()
    fr = gqmap_tpu_torch.FlowRange(*FR)
    a = pg.init_state(pc, fr, (24, 28), seed=5, device="cpu")
    b = pg.init_state(pc, fr, (24, 28), seed=5, device="cpu")
    c = pg.init_state(pc, fr, (24, 28), seed=6, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.muu, c.muu)
    assert a.muu.shape == (3, 24, 28) and a.rou.shape == (2, 2, 3, 24, 28)
    assert a.muu.dtype == torch.float64 and a.it.dtype == torch.int32 and int(a.it) == 1
    assert (a.muu >= -2).all() and (a.muu <= 2).all()
    assert (a.sigmau >= 4).all() and (a.sigmau <= 5).all()
    assert not a.pn.any() and not a.rou.any()
