"""The super lattice (``patch = 4``) of the port against the JAX engine.

Two presets run on it: ``super_entropy`` (the exact patch-summed bicubic
node term, tensor-rule edges on kernel K3's K = 11 rule, entropy annealing)
and ``tpu_fast_super`` (the cosine data term at 96x16 degrees over the
patch-summed potential, kernel K1, and reduced edges on K2's K1 = 25 rule).
A shifted pair of 32x40 frames gives an 8x10 flow lattice; everything runs
in float64, and both engines start from the JAX problem and initial state,
passed to the port as numpy arrays (``gqmap_tpu_torch.convert``). The
engine tests cut the presets to K = 5 and 16x8 cosine degrees; the kernel
tests run the presets' own rules and degrees.

Tolerances, as in ``test_torch_slice.py``: the node potential, the
coefficient field and each kernel's plain version at 1e-10 of the output's
largest magnitude (1e-12 for the field); one sweep at 1e-10 relative;
30-sweep segments and 60-sweep solves at ``corr_tor = 0.99`` (ROADMAP
Queue 3, P1) at 1e-8, the readouts at 1e-7 (logP, AEPE) and 1e-6 absolute
(MAP, whose golden-section search resolves a mode to ~sqrt(eps) sigma).
The cosine series against the exact data term is an approximation: its
mean error is held under 1% of the term's largest magnitude, as the JAX
package's own check of the chebyshev series is.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, assert_fields_close, np_fields, port_state,
                           shifted_pair, t)
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.kernels.cosine_gq import cos_mode_sums_pallas
from gqmap_tpu.kernels.edge_gq import edge_gq_pallas
from gqmap_tpu.kernels.edge_reduced_gq import edge_reduced_grads_pallas
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import cosine as jcos
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu_torch.convert import problem_from_numpy, state_from_numpy
from gqmap_tpu_torch.kernels import cosine_gq, edge_gq, edge_reduced_gq
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import cosine, potentials
from gqmap_tpu_torch.ops.gq import EDGE

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
FR = (-2.0, 2.0, -2.0, 2.0)
SHAPE = (32, 40)  # frames; the flow lattice is 8x10
LATTICE = (8, 10)
TOY = dict(K=5, cheb_p=16, cheb_q=8, L=3, dtype="float64", its=60, eval_every=30)
PRESETS = ("super_entropy", "tpu_fast_super")
KERNELS = (cosine_gq.cos_mode_sums_cuda, edge_reduced_gq.edge_reduced_grads_cuda,
           edge_gq.edge_gq_cuda)


def _cfgs(preset, **kw):
    kw = {**TOY, **kw}
    return (getattr(gqmap_tpu.GQMAPConfig, preset)(**kw),
            getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw))


def _port_problem(jp):
    return problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab), interior=np.asarray(jp.interior),
        rng=tuple(jp.rng), cheb=None if jp.cheb is None else np_fields(jp.cheb)), device="cpu")


@pytest.fixture(scope="module")
def toy():
    I1, I2, gt = shifted_pair(*SHAPE)
    fr = gqmap_tpu.FlowRange(*FR)
    out = dict(I1=I1, I2=I2, gt=gt)
    for preset in PRESETS:
        jc, _ = _cfgs(preset)
        jp = jg.make_problem(jc, I1, I2, fr)
        out[preset] = dict(jp=jp, pp=_port_problem(jp), js=jg.init_state(jc, fr, I1.shape),
                           jsweep=jax.jit(jg.make_sweep(jc, I1.shape)))
    return out


# --- the patch-summed node term and coefficient field -----------------------

def test_node_pot_bicubic_patch_matches(toy):
    jp = toy["super_entropy"]["jp"]
    r = np.random.default_rng(5)
    # a leading quadrature-chunk axis and the mixture axis, as gq_accumulate gives them
    x1, x2 = r.uniform(-2, 2, (4, 3) + LATTICE), r.uniform(-2, 2, (4, 3) + LATTICE)
    want = np.asarray(jpot.make_node_pot_bicubic(jp.I1, jp.I2_tab, 1.0, 1e-6, patch=4)(
        jnp.asarray(x1), jnp.asarray(x2)))
    got = potentials.make_node_pot_bicubic(t(jp.I1), t(jp.I2_tab), 1.0, 1e-6, patch=4)(
        t(x1), t(x2))
    assert got.shape == want.shape == (4, 3) + LATTICE
    assert_close(got, want, 0, 1e-10 * np.abs(want).max(), "node potential")


def test_build_cos_data_patch_matches(toy):
    jp = toy["tpu_fast_super"]["jp"]
    box = (-3.0, 2.0, -1.5, 1.5)
    want = jcos.build_cos_data(jp.I1, jp.I2_tab, 1.0, 1e-6, box, A=24, B=8, patch=4)
    got = cosine.build_cos_data(t(jp.I1), t(jp.I2_tab), 1.0, 1e-6, box, A=24, B=8, patch=4)
    w = np.asarray(want.coeffs)
    assert got.coeffs.shape == w.shape == (24, 8) + LATTICE
    assert_close(got.coeffs, w, 0, 1e-12 * np.abs(w).max(), "coeffs")
    # the toy preset's field, over the flow range and margin
    _, pc = _cfgs("tpu_fast_super")
    pp = pg.make_problem(pc, toy["I1"], toy["I2"], gqmap_tpu_torch.FlowRange(*FR),
                         device="cpu")
    w = np.asarray(jp.cheb.coeffs)
    assert pp.cheb.coeffs.shape == w.shape == (16, 8) + LATTICE
    assert_close(pp.cheb.coeffs, w, 0, 1e-12 * np.abs(w).max(), "preset coeffs")


def test_cosine_series_matches_exact_super_data_term(toy):
    # mirror of tests/test_solver.py::test_chebyshev_super_patch with the
    # cosine term: the coefficients expand the PATCH-SUMMED potential, so the
    # series summed directly from them must match the exact super data term
    _, pe_cfg = _cfgs("super_entropy", K=3)
    _, pc_cfg = _cfgs("tpu_fast_super", K=3, cheb_p=48, cheb_q=48, cheb_margin=1.0)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    pe = pg.make_problem(pe_cfg, toy["I1"], toy["I2"], fr, device="cpu")
    pc = pg.make_problem(pc_cfg, toy["I1"], toy["I2"], fr, device="cpu")
    r = np.random.default_rng(0)
    x1, x2 = t(r.uniform(-2, 2, (2, 1) + LATTICE)), t(r.uniform(-2, 2, (2, 1) + LATTICE))
    ve = potentials.make_node_pot_bicubic(pe.I1, pe.I2_tab, 1.0, 1e-6, patch=4)(x1, x2)
    cd = pc.cheb
    A, B = cd.coeffs.shape[:2]
    th1 = math.pi * (x1 - cd.lo_u) / (cd.hi_u - cd.lo_u)
    th2 = math.pi * (x2 - cd.lo_v) / (cd.hi_v - cd.lo_v)
    cu = torch.cos(torch.arange(A, dtype=torch.float64).reshape(A, 1, 1, 1, 1) * th1)
    cv = torch.cos(torch.arange(B, dtype=torch.float64).reshape(B, 1, 1, 1, 1) * th2)
    vc = torch.einsum("abmn,aijmn,bijmn->ijmn", cd.coeffs, cu, cv)
    assert float((ve - vc).abs().mean() / ve.abs().max()) < 0.01


# --- the three kernels' plain versions at the super presets' rules ----------

@pytest.mark.parametrize("variant", ["v1", "recur"])
def test_mode_sums_on_patch_summed_field_match_pallas_interpret(toy, variant):
    # K1 at A = 96 on the coefficient field of tpu_fast_super at its own
    # degrees (each coefficient a sum of 16 pixels' potentials), from a wide
    # and a tight state
    jp = toy["tpu_fast_super"]["jp"]
    jc = jcos.build_cos_data(jp.I1, jp.I2_tab, 1.0, 1e-6, (-4.0, 4.0, -4.0, 4.0), A=96, B=16,
                             patch=4)
    pc = cosine.CosData(t(jc.coeffs), float(jc.lo_u), float(jc.hi_u), float(jc.lo_v),
                        float(jc.hi_v))
    r = np.random.default_rng(11)
    site = (3,) + LATTICE
    for sig_hi in (3.0, 0.06):
        s = (r.uniform(-2, 2, site), r.uniform(-2, 2, site), r.uniform(0.01, sig_hi, site),
             r.uniform(0.01, sig_hi, site), r.uniform(-0.9, 0.9, site))
        want = cos_mode_sums_pallas(jc, *map(jnp.asarray, s), rows=8, interpret=True,
                                    variant=variant)
        got = cosine._mode_sums(pc, *map(t, s))
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert_close(g, w, 0, 1e-10 * np.abs(w).max(), f"sum {k} sigma<{sig_hi}")


def _edge_inputs(seed, rho):
    r = np.random.default_rng(seed)
    L, (M, N) = 3, LATTICE
    mu = 3 * r.normal(size=(2, L, M, N))
    sg = r.uniform(0.01, 3, (2, L, M, N))
    if rho == "warm":
        rou = r.uniform(-0.9, 0.9, (2, 2, L, M, N))
    else:  # the corr_tor clamp, random sign
        rou = 0.99999 * np.where(r.uniform(size=(2, 2, L, M, N)) < 0.5, -1.0, 1.0)
    u2e = np.stack([np.roll(mu, -1, -2), np.roll(mu, -1, -1)])
    o2e = np.stack([np.roll(sg, -1, -2), np.roll(sg, -1, -1)])
    return mu, sg, u2e, o2e, rou


@pytest.mark.parametrize("T", [0.0, 0.2])
def test_edge_reduced_k1_25_matches_pallas_interpret(T):
    # K2 on its K1 = 25 rule (tpu_fast_super: K = 11), at T = 0 and at the
    # presets' initial T. Not at the |rho| clamp: there the variance c of
    # the difference cancels, and two f64 summation orders differ by ~1e-9
    # of the largest gradient (chip_smoke.py holds K2 to the f64 golden there)
    mu, sg, u2e, o2e, rou = _edge_inputs(21, "warm")
    alpha = np.array([0.5, 0.3, 0.2])
    want = edge_reduced_grads_pallas(*map(jnp.asarray, (mu, sg, u2e, o2e, rou, alpha)),
                                     jnp.asarray(T), 25, 16.0, 1e-6, EDGE, rows=8,
                                     interpret=True)
    got = edge_reduced_gq.edge_reduced_grads_torch(*map(t, (mu, sg, rou, alpha)), t(T), 25,
                                                   16.0, 1e-6, EDGE)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert_close(getattr(got, name), w, 0, 1e-10 * np.abs(w).max(), name)


@pytest.mark.parametrize("rho", ["warm", "clamp"])
def test_edge_gq_k11_matches_pallas_interpret(rho):
    # K3 on its K = 11 rule (super_entropy), 121 points
    mu, sg, u2e, o2e, rou = _edge_inputs(22, rho)
    j = [jnp.asarray(a) for a in (mu, sg, u2e, o2e, rou)]
    want = edge_gq_pallas(j[0][None], j[2], j[1][None], j[3], j[4], 11, 16.0, 1e-6, rows=8,
                          interpret=True)
    got = edge_gq.edge_gq_torch(*map(t, (mu, sg, u2e, o2e, rou)), 11, 16.0, 1e-6)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert_close(getattr(got, name), w, 0, 1e-10 * np.abs(w).max(), name)


# --- the engine on the super lattice ----------------------------------------

@pytest.mark.parametrize("warm", [0, 20])
@pytest.mark.parametrize("preset", PRESETS)
def test_one_sweep_matches(toy, preset, warm):
    _, pc = _cfgs(preset)
    d = toy[preset]
    js = d["js"]
    for _ in range(warm):
        js, _ = d["jsweep"](d["jp"], js)
    j1, jaux = d["jsweep"](d["jp"], js)
    p1, paux = pg.make_sweep(pc, SHAPE)(d["pp"], port_state(js))
    assert p1.muu.shape == (3,) + LATTICE and p1.rou.shape == (2, 2, 3) + LATTICE
    assert_fields_close(p1, j1, 1e-10, 1e-10, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("preset", PRESETS)
def test_segment_matches(toy, preset):
    jc, pc = _cfgs(preset, corr_tor=0.99)
    d = toy[preset]
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, SHAPE)(d["jp"], d["js"], 30)
    pst, pn, peb, ppb, psb, pstop = pg.make_segment_runner(pc, SHAPE)(
        d["pp"], port_state(d["js"]), 30)
    assert pn == int(jn) == 30 and pstop == bool(jstop) is False
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:30], np.asarray(w)[:30], 1e-8, 0)


@pytest.mark.parametrize("preset", PRESETS)
def test_solve_matches(toy, preset):
    jc, pc = _cfgs(preset, corr_tor=0.99)
    js = toy[preset]["js"]
    jr = jg.solve(jc, toy["I1"], toy["I2"], gt_flow=toy["gt"], init=js,
                  flow_range=gqmap_tpu.FlowRange(*FR))
    pr = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                               init=port_state(js),
                               flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    assert pr.iters == jr.iters == 60 and pr.map.shape == LATTICE + (2,)
    evals = [0, 29, 59]
    assert_close(pr.AEPE[evals], jr.AEPE[evals], 1e-7, 0, "AEPE")
    assert_close(pr.logP[evals], jr.logP[evals], 1e-7, 0, "logP")
    assert_close(pr.Energy, jr.Energy, 1e-8, 0, "Energy")
    assert_close(pr.map, jr.map, 0, 1e-6, "map")
    assert abs(pr.best_aepe - jr.best_aepe) <= 1e-7 * jr.best_aepe
    for name in ("mu", "sigma", "alpha"):
        assert_close(getattr(pr, name), getattr(jr, name), 1e-8, 1e-8, name)


def test_annealed_temperature_matches():
    # mirror of tests/test_solver.py::test_super_annealing: two decays, at
    # it = 10 and 20, give 0.2 * 0.75^2; the whole trace matches JAX's
    I1, I2, gt = shifted_pair(16, 16)
    kw = dict(K=3, its=25, eval_every=100, anneal_every=10, dtype="float64")
    jr = jg.solve(gqmap_tpu.GQMAPConfig.super_entropy(**kw), I1, I2, gt_flow=gt,
                  flow_range=gqmap_tpu.FlowRange(*FR))
    js0 = jg.init_state(gqmap_tpu.GQMAPConfig.super_entropy(**kw), gqmap_tpu.FlowRange(*FR),
                        I1.shape)
    pr = gqmap_tpu_torch.solve(gqmap_tpu_torch.GQMAPConfig.super_entropy(**kw), I1, I2,
                               gt_flow=gt, flow_range=gqmap_tpu_torch.FlowRange(*FR),
                               init=port_state(js0), device="cpu")
    assert float(pr.state.temperature) == pytest.approx(0.2 * 0.75 ** 2, rel=1e-15)
    assert float(pr.state.temperature) == float(jr.state.temperature)
    assert_close(pr.Energy, jr.Energy, 1e-8, 0, "Energy")


def test_readouts_match(toy):
    # logP through the patch-summed node potential (whatever the data term),
    # and the AEPE of a lattice MAP repeated to full resolution, 4-px crop
    r = np.random.default_rng(3)
    flow = r.uniform(-2, 2, LATTICE + (2,))
    unknown = r.uniform(size=SHAPE) < 0.1
    for preset in PRESETS:
        jc, pc = _cfgs(preset)
        want = jg.make_logp_fn(jc, SHAPE)(toy[preset]["jp"], flow)
        got = pg.make_logp_fn(pc, SHAPE)(toy[preset]["pp"], t(flow))
        assert_close(got, want, 1e-10, 0, f"logP {preset}")
        assert pg.aepe_of(pc, flow, toy["gt"], unknown) == pytest.approx(
            jg.aepe_of(jc, flow, toy["gt"], unknown), rel=1e-12)


def test_window_rg_with_patch_raises_value_error(toy):
    for preset in PRESETS:
        jc, pc = _cfgs(preset, window_rg=2)
        with pytest.raises(ValueError, match="mutually exclusive"):
            jg.make_problem(jc, toy["I1"], toy["I2"], gqmap_tpu.FlowRange(*FR))
        with pytest.raises(ValueError, match="mutually exclusive"):
            pg.make_problem(pc, toy["I1"], toy["I2"], gqmap_tpu_torch.FlowRange(*FR),
                            device="cpu")


def test_convert_takes_super_shapes(toy):
    d = toy["tpu_fast_super"]
    jp, js = d["jp"], d["js"]
    pp = d["pp"]
    assert pp.cheb.coeffs.shape == (16, 8) + LATTICE and pp.interior.shape == LATTICE
    assert pp.I1.shape == SHAPE and pp.interior.dtype == torch.bool
    np.testing.assert_array_equal(pp.cheb.coeffs.numpy(), np.asarray(jp.cheb.coeffs))
    assert (pp.cheb.lo_u, pp.cheb.hi_v) == (float(jp.cheb.lo_u), float(jp.cheb.hi_v))
    ps = state_from_numpy(np_fields(js), device="cpu")
    assert ps.muu.shape == (3,) + LATTICE and ps.rou.shape == (2, 2, 3) + LATTICE
    assert ps.it.dtype == torch.int32
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)), f)
    # and the exact preset's problem, which has no coefficient field
    assert toy["super_entropy"]["pp"].cheb is None


def test_cpu_run_launches_no_kernel(toy):
    before = [k.launches for k in KERNELS]
    for preset in PRESETS:
        _, pc = _cfgs(preset, its=3)
        res = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                                    flow_range=gqmap_tpu_torch.FlowRange(*FR), device="cpu")
        assert res.iters == 3 and np.isfinite(res.Energy).all()
        assert res.map.shape == LATTICE + (2,)
    assert [k.launches for k in KERNELS] == before == [0, 0, 0]


def test_patch_config_reaches_every_layer(toy):
    # the presets are what the JAX package defines, and run through check_supported
    for preset in PRESETS:
        jc, pc = _cfgs(preset)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc) and pc.patch == 4
        pg.check_supported(pc)
        assert pg.flow_lattice_shape(pc, SHAPE) == LATTICE
