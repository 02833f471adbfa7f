"""The port's reference-parity exact path (``full_mixture``) and the rest of
``solve``'s surface, against the JAX engine.

A shifted-pair toy problem (24x28, K=5, L=3) in float64: the bicubic node
term through the K^2-point tensor rule and tensor-rule Charbonnier edges
(the plain version of kernel K3 here; JAX's default XLA tensor path, whose
maths is the same). Both engines start from the JAX problem and initial
state, passed to the port as numpy arrays (``jax.random`` and
``torch.Generator`` give different bits from one seed).

Tolerances, as in ``test_torch_slice.py``: one sweep at 1e-10 relative, also
from a state 20 sweeps on with the correlations at the |rho| clamp; multi-
sweep runs at 1e-8, the readouts at 1e-7 (logP, AEPE) and 1e-6 absolute
(MAP). Two measured properties of the exact path set where they apply:

* at the clamp, 1/(1-rho^2) ~ 5e4 turns the last-bit differences of any two
  f64 summation orders of the bicubic node sums into ~1e-9 in the updated
  means: JAX against itself, one chunk against ``quad_chunk`` 1 or 7,
  differs by 1.3e-9 in mu there. So after that one sweep the means are held
  to at most twice JAX's own spread, every other field to 1e-10;
* with the flagship step (0.1) the exact path is chaotic on the toy: two JAX
  summation orders (``quad_chunk`` 0 and 7) separate to 4e-4 in energy by
  sweep 55, even at ``corr_tor=0.99``. The 30-sweep segment runs at
  ``corr_tor=0.99`` (ROADMAP Queue 3, P1); the solves, which run to 60
  sweeps, at ``step0=0.03, corr_tor=0.95`` (:data:`STABLE`), where the two
  JAX orders agree to 1e-15 over 60 sweeps.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_common import assert_close, assert_fields_close, port_state, shifted_pair, t
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.evals import metrics as jmetrics
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import gq as jgq
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops import quadrature as jquad
from gqmap_tpu.utils import checkpoint as jckpt
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.evals import metrics as pmetrics
from gqmap_tpu_torch.kernels.edge_gq import edge_gq_cuda
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import gq as pgq
from gqmap_tpu_torch.ops import potentials as ppot
from gqmap_tpu_torch.ops import quadrature as pquad
from gqmap_tpu_torch.utils import checkpoint as pckpt

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
FR = (-2.0, 2.0, -2.0, 2.0)
TOY = dict(K=5, L=3, dtype="float64", its=60, eval_every=30)
STABLE = dict(step0=0.03, corr_tor=0.95)  # see the module docstring


def _cfgs(**kw):
    kw = {**TOY, **kw}
    return gqmap_tpu.GQMAPConfig.full_mixture(**kw), gqmap_tpu_torch.GQMAPConfig.full_mixture(**kw)


def exact_problem(jp):
    """The port's exact-path Problem holding exactly the JAX Problem's arrays."""
    return problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                   interior=np.asarray(jp.interior), rng=tuple(jp.rng),
                                   cheb=None), device="cpu")


@pytest.fixture(scope="module")
def toy():
    I1, I2, gt = shifted_pair()
    jc, _ = _cfgs()
    fr = gqmap_tpu.FlowRange(*FR)
    jp = jg.make_problem(jc, I1, I2, fr)
    js = jg.init_state(jc, fr, I1.shape)
    return dict(I1=I1, I2=I2, gt=gt, jp=jp, js=js, pp=exact_problem(jp),
                jsweep=jax.jit(jg.make_sweep(jc, I1.shape)))


def _solve_pair(toy, jc, pc, **kw):
    """The same solve in both packages, each from the JAX initial state."""
    jr = jg.solve(jc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                  flow_range=gqmap_tpu.FlowRange(*FR), **kw)
    pr = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                               flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu",
                               **{k: port_state(v) if k == "init" else v for k, v in kw.items()})
    return jr, pr


def _assert_results_close(pr, jr, evals):
    assert pr.iters == jr.iters
    assert_close(pr.AEPE[evals], jr.AEPE[evals], 1e-7, 0, "AEPE")
    assert_close(pr.logP[evals], jr.logP[evals], 1e-7, 0, "logP")
    assert_close(pr.Energy, jr.Energy, 1e-8, 0, "Energy")
    assert_close(pr.map, jr.map, 0, 1e-6, "map")
    assert abs(pr.best_aepe - jr.best_aepe) <= 1e-7 * jr.best_aepe
    for name in ("mu", "sigma", "alpha"):
        assert_close(getattr(pr, name), getattr(jr, name), 1e-8, 1e-8, name)


@pytest.mark.parametrize("chunk", [0, 7])
def test_build_table_matches(chunk):
    got = pquad.build_table(5, chunk, np.float64)
    want = jquad.build_table(5, chunk, np.float64)
    assert got.steps == want.steps and got.chunk == want.chunk
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
    if chunk == 7:  # 25 points in 4 steps of 7: three zero-weight pad points
        assert got.steps == 4 and not got.wiwj.reshape(-1)[25:].any()


@pytest.mark.parametrize("pot", ["node_bicubic", "edge"])
def test_gq_accumulate_matches(toy, pot):
    r = np.random.default_rng(7)
    L, (M, N) = 3, toy["I1"].shape
    site = (L, M, N) if pot == "node_bicubic" else (2, 2, L, M, N)
    u1, u2 = r.uniform(-2, 2, site), r.uniform(-2, 2, site)
    o1, o2 = r.uniform(0.05, 3, site), r.uniform(0.05, 3, site)
    p = r.uniform(-0.99, 0.99, site)
    jp = toy["jp"]
    if pot == "node_bicubic":
        jf = jpot.make_node_pot_bicubic(jp.I1, jp.I2_tab, 1.0, 1e-6, pack=True)
        pf = ppot.make_node_pot_bicubic(t(jp.I1), t(jp.I2_tab), 1.0, 1e-6)
    else:
        jf, pf = jpot.make_edge_pot(5.0, 1e-6), ppot.make_edge_pot(5.0, 1e-6)
    # chunk 7 pads the 25-point rule with three zero-weight points
    want = jgq.gq_accumulate(jf, u1, u2, o1, o2, p, jquad.build_table(5, 7, np.float64))
    got = pgq.gq_accumulate(pf, *map(t, (u1, u2, o1, o2, p)),
                            pquad.build_table(5, 7, np.float64))
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert_close(getattr(got, name), w, 1e-10, 1e-10 * np.abs(w).max(), name)


def test_make_problem_matches(toy):
    _, pc = _cfgs()
    for fr in (gqmap_tpu_torch.FlowRange(*FR), None):  # the exact path needs no range
        pp = pg.make_problem(pc, toy["I1"], toy["I2"], fr, device="cpu")
        assert pp.cheb is None and pp.rng == fr
        for name in ("I1", "I2_tab", "interior"):
            assert_close(getattr(pp, name), getattr(toy["jp"], name), 1e-12, 0, name)


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
    means = ("muu", "muv") if warm else ()
    assert_fields_close(p1, j1, 1e-10, 1e-10, [f for f in FIELDS if f not in means])
    assert_fields_close(paux, jaux, 1e-10, 1e-12)
    if warm:
        jc, _ = _cfgs()
        spread = dict.fromkeys(means, 0.0)
        for chunk in (1, 7):
            jo, _ = jax.jit(jg.make_sweep(dataclasses.replace(jc, quad_chunk=chunk),
                                          toy["I1"].shape))(toy["jp"], js)
            for f in means:
                spread[f] = max(spread[f], float(np.abs(np.asarray(getattr(jo, f))
                                                        - np.asarray(getattr(j1, f))).max()))
        for f in means:
            err = float(np.abs(getattr(p1, f).numpy() - np.asarray(getattr(j1, f))).max())
            assert 0 < spread[f] < 1e-8 and err <= 2.0 * spread[f], (f, err, spread[f])


def test_segment_matches(toy):
    jc, pc = _cfgs(corr_tor=0.99, quad_chunk=7)
    shape = toy["I1"].shape
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, shape)(toy["jp"], toy["js"], 30)
    pst, pn, peb, ppb, psb, pstop = pg.make_segment_runner(pc, shape)(
        toy["pp"], port_state(toy["js"]), 30)
    assert pn == int(jn) == 30 and pstop == bool(jstop) is False
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:30], np.asarray(w)[:30], 1e-8, 0)


def test_solve_matches(toy):
    jr, pr = _solve_pair(toy, *_cfgs(**STABLE), init=toy["js"])
    assert pr.iters == 60
    assert np.isnan(pr.AEPE[10]) and np.isnan(pr.logP[10])
    _assert_results_close(pr, jr, [0, 29, 59])
    assert pr.AEPE[59] < pr.AEPE[0]  # the solver optimizes from the random init


def test_init_flow_matches(toy, monkeypatch):
    # the port's own random init differs from jax.random's, so its init_state
    # hands out the JAX initial state; init_flow then replaces the means
    monkeypatch.setattr(pg, "init_state", lambda *a, **k: port_state(toy["js"]))
    r = np.random.default_rng(4)
    flow = r.uniform(-3, 3, toy["I1"].shape + (2,))  # partly outside the range: clamped
    jr, pr = _solve_pair(toy, *_cfgs(its=10, eval_every=5, **STABLE), init_flow=flow)
    _assert_results_close(pr, jr, [0, 4, 9])
    with pytest.raises(ValueError, match="init_flow shape"):
        gqmap_tpu_torch.solve(_cfgs()[1], toy["I1"], toy["I2"], init_flow=flow[1:],
                               flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")


def test_reset_at_matches(toy):
    jr, pr = _solve_pair(toy, *_cfgs(its=12, eval_every=5, **STABLE), init=toy["js"],
                         reset_at=7)
    # the schedule restarts after sweep 7: 12 more sweeps, readouts at 1, 5, 10
    assert pr.iters == 12
    _assert_results_close(pr, jr, [0, 4, 9])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages_and_resumes(toy, tmp_path, writer):
    jc10, pc10 = _cfgs(its=10, eval_every=5, **STABLE)
    jc20, pc20 = _cfgs(its=20, eval_every=5, **STABLE)
    ck = str(tmp_path / "ck.npz")
    fr = (gqmap_tpu.FlowRange(*FR), gqmap_tpu_torch.FlowRange(*FR))
    if writer == "jax":
        first = jg.solve(jc10, toy["I1"], toy["I2"], gt_flow=toy["gt"], flow_range=fr[0],
                         init=toy["js"], checkpoint_path=ck)
        state, cfg, extras = pckpt.load_checkpoint(ck, expect_cfg=pc20, device="cpu")
        assert cfg == pc10
        resumed = gqmap_tpu_torch.solve(pc20, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                        flow_range=fr[1], checkpoint_path=ck, resume=True,
                                        device="cpu")
        full = gqmap_tpu_torch.solve(pc20, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                     flow_range=fr[1], init=port_state(toy["js"]),
                                     device="cpu")
    else:
        first = gqmap_tpu_torch.solve(pc10, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                      flow_range=fr[1], init=port_state(toy["js"]),
                                      checkpoint_path=ck, device="cpu")
        state, cfg, extras = jckpt.load_checkpoint(ck, expect_cfg=jc20)
        assert cfg == jc10
        resumed = jg.solve(jc20, toy["I1"], toy["I2"], gt_flow=toy["gt"], flow_range=fr[0],
                           checkpoint_path=ck, resume=True)
        full = jg.solve(jc20, toy["I1"], toy["I2"], gt_flow=toy["gt"], flow_range=fr[0],
                        init=toy["js"])
    assert_fields_close(state, first.state, 0, 0, FIELDS)
    assert float(extras["best_aepe"]) == first.best_aepe
    # resumed to 20 == unbroken 20, traces and best AEPE included
    assert resumed.iters == full.iters == 20
    for name in ("AEPE", "Energy", "logP"):
        assert_close(getattr(resumed, name), getattr(full, name), 1e-8, 0, name)
    assert resumed.best_aepe == pytest.approx(full.best_aepe, rel=1e-8)
    assert_close(resumed.mu, full.mu, 1e-8, 1e-8, "mu")
    assert_close(resumed.sigma, full.sigma, 1e-8, 1e-8, "sigma")


def test_checkpoint_refuses_other_config(toy, tmp_path):
    _, pc = _cfgs()
    ck = tmp_path / "ck.npz"
    pckpt.save_checkpoint(ck, port_state(toy["js"]), pc, best_aepe=1.5)
    state, cfg, extras = pckpt.load_checkpoint(ck, expect_cfg=dataclasses.replace(pc, its=7),
                                               device="cpu")
    assert cfg == pc and float(extras["best_aepe"]) == 1.5 and state.it.dtype == torch.int32
    with pytest.raises(ValueError, match="does not match"):
        pckpt.load_checkpoint(ck, expect_cfg=dataclasses.replace(pc, K=7), device="cpu")


def test_metrics_match(toy, tmp_path):
    r = np.random.default_rng(5)
    flow = r.uniform(-2, 2, toy["I1"].shape + (2,))
    unknown = r.uniform(size=toy["I1"].shape) < 0.1
    for crop in (0, 1, 2):
        assert pmetrics.aepe(flow, toy["gt"], unknown, crop) == jmetrics.aepe(
            flow, toy["gt"], unknown, crop)
    logs = {}
    for name, mod in (("jax", jmetrics), ("port", pmetrics)):
        ml = mod.MetricsLogger(tmp_path / name / "m.jsonl", run_meta=dict(seq="toy"))
        cb = ml.solver_callback(pixels=672)
        cb(300, None, flow, np.float64(0.5), -12.5)
        cb(600, None, flow, np.nan, -11.0)
        logs[name] = [json.loads(x) for x in open(ml.path)]
    strip = ("t", "sweeps_per_s", "mpix_sweeps_per_s")
    assert ([{k: v for k, v in x.items() if k not in strip} for x in logs["port"]]
            == [{k: v for k, v in x.items() if k not in strip} for x in logs["jax"]])


def test_cpu_run_launches_no_kernel(toy):
    _, pc = _cfgs(its=3)
    res = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    assert edge_gq_cuda.launches == 0
    # the explicit kernel route refuses CPU tensors instead of falling back
    _, cuda_cfg = _cfgs(edge_kernel="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.make_sweep(cuda_cfg, toy["I1"].shape)(toy["pp"], port_state(toy["js"]))
    assert edge_gq_cuda.launches == 0


def test_no_silent_cpu_fallback(toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _cfgs(its=2, eval_every=1)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    shape = toy["I1"].shape
    for call in (lambda **k: gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], flow_range=fr, **k),
                 lambda **k: pg.make_problem(pc, toy["I1"], toy["I2"], fr, **k),
                 lambda **k: pg.init_state(pc, fr, shape, **k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    res = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], flow_range=fr, device="cpu")
    assert res.iters == 2 and res.state.muu.device.type == "cpu"
    assert pg.make_problem(pc, toy["I1"], toy["I2"], fr, device="cpu").I1.device.type == "cpu"
    assert pg.init_state(pc, fr, shape, device="cpu").muu.device.type == "cpu"
