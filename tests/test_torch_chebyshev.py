"""The port's Chebyshev data term (``data_term="chebyshev"``) against the
JAX package's.

``gqmap_tpu_torch/ops/chebyshev.py`` against ``gqmap_tpu/ops/chebyshev.py``
on 24x28 shifted pairs in float64: the coefficient field and the series'
values inside and outside the displacement box, at patch 1 and 4 and with
``window_rg = 2``, within 1e-10 of the largest magnitude; one
``full_mixture`` and one ``tpu_fast`` sweep with the term (and one autodiff
sweep) at 1e-10 relative with 1e-12 absolute, a 30-sweep segment at
``corr_tor = 0.99`` (ROADMAP Queue 3, P1) and a solve's readouts at 1e-8,
logP at 1e-10, both engines from the JAX problem and initial state. Then the
port's twins of the JAX package's own tests of the term, held to the same
bounds as there. The sharded sweep with the term is a case of
``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_common import assert_close, assert_fields_close, np_fields, port_state, shifted_pair, t
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops import chebyshev as jcheb
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import cosine_gq, edge_gq, edge_reduced_gq
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import chebyshev

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
FR = (-2.0, 2.0, -2.0, 2.0)
SHAPE = (24, 28)
SPECTRAL = dict(data_term="chebyshev", cheb_p=12, cheb_q=8)
CASES = {
    "full_mixture": ("full_mixture", dict(K=5, L=2, **SPECTRAL)),
    "tpu_fast": ("tpu_fast", dict(K=5, L=2, **SPECTRAL)),
    "full_mixture chunked": ("full_mixture", dict(K=5, L=2, quad_chunk=7, **SPECTRAL)),
    "autodiff": ("full_mixture", dict(K=3, L=2, gradient_estimator="autodiff", **SPECTRAL)),
    "super": ("super_entropy", dict(K=3, **SPECTRAL)),
}
KERNELS = (cosine_gq.cos_mode_sums_cuda, edge_reduced_gq.edge_reduced_grads_cuda,
           edge_gq.edge_gq_cuda)


@pytest.fixture(scope="module")
def toy():
    I1, I2, gt = shifted_pair(*SHAPE)
    return dict(I1=I1, I2=I2, gt=gt)


def _cfgs(preset, **kw):
    kw = {"dtype": "float64", "its": 60, "eval_every": 30, **kw}
    return (getattr(gqmap_tpu.GQMAPConfig, preset)(**kw),
            getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw))


def _problems(jc, I1, I2):
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))
    pp = problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                 interior=np.asarray(jp.interior), rng=tuple(jp.rng),
                                 cheb=np_fields(jp.cheb)), device="cpu", data_term="chebyshev")
    return jp, pp


def _close_rel(got, want, name="", tol=1e-10):
    w = np.asarray(want)
    assert tuple(got.shape) == w.shape, (name, tuple(got.shape), w.shape)
    assert_close(got, w, 0, tol * max(np.abs(w).max(), 1e-300), name)


def test_nodes_and_dct_matrix_match():
    for n in (1, 8, 13):
        np.testing.assert_array_equal(chebyshev._cheb_nodes(n), jcheb._cheb_nodes(n))
        np.testing.assert_array_equal(chebyshev._dct_matrix(n), jcheb._dct_matrix(n))


BUILDS = {"patch 1": dict(), "patch 4": dict(patch=4), "window_rg 2": dict(window_rg=2)}


@pytest.mark.parametrize("build", list(BUILDS))
def test_coefficients_and_series_match(toy, build):
    kw = BUILDS[build]
    box = (-3.0, 2.5, -1.5, 1.5)
    VV = jinterp.pad_cubic(jnp.asarray(toy["I2"]))
    want = jcheb.build_cheb_data(jnp.asarray(toy["I1"]), VV, 1.0, 1e-6, box, P=12, Q=8, **kw)
    got = chebyshev.build_cheb_data(t(toy["I1"]), t(np.asarray(VV)), 1.0, 1e-6, box, P=12, Q=8,
                                    **kw)
    _close_rel(got.coeffs, want.coeffs, "coeffs")
    assert got.coeffs.permute(2, 3, 0, 1).is_contiguous()  # site major
    assert (got.lo_u, got.hi_u, got.lo_v, got.hi_v) == box
    # samples inside and beyond the box on both axes (clipped to its edge)
    M, N = got.coeffs.shape[-2:]
    r = np.random.default_rng(1)
    x1, x2 = r.uniform(-5, 4.5, (3, 2, M, N)), r.uniform(-3, 3, (3, 2, M, N))
    assert (x1 < box[0]).any() and (x1 > box[1]).any() and (x2 > box[3]).any()
    wv = jcheb.make_node_pot_chebyshev(want, a_block=5)(jnp.asarray(x1), jnp.asarray(x2))
    _close_rel(chebyshev.make_node_pot_chebyshev(got)(t(x1), t(x2)), wv, "values")
    # broadcast site arrays, one sample a site
    wv = jcheb.make_node_pot_chebyshev(want)(jnp.asarray(x1[0, 0]), jnp.asarray(x2[:, :1]))
    _close_rel(chebyshev.make_node_pot_chebyshev(got)(t(x1[0, 0]), t(x2[:, :1])), wv, "bcast")


def test_series_is_independent_of_layout_and_site_chunks(toy, monkeypatch):
    # a field in the plain (P, Q, M, N) layout, and sites split over chunks,
    # give the same values as the site-major field in one chunk
    box = (-3.0, 2.5, -1.5, 1.5)
    got = chebyshev.build_cheb_data(t(toy["I1"]), t(np.asarray(jinterp.pad_cubic(
        jnp.asarray(toy["I2"])))), 1.0, 1e-6, box, P=12, Q=8)
    r = np.random.default_rng(2)
    x1, x2 = (t(r.uniform(-3, 3, (5,) + SHAPE)) for _ in range(2))
    want = chebyshev.make_node_pot_chebyshev(got)(x1, x2)
    plain = got._replace(coeffs=got.coeffs.contiguous())
    assert not plain.coeffs.permute(2, 3, 0, 1).is_contiguous()
    monkeypatch.setattr(chebyshev, "_EVAL_CHUNK_ELEMS", 5 * 12 * 100)  # 100 sites a chunk
    for field in (got, plain):
        _close_rel(chebyshev.make_node_pot_chebyshev(field)(x1, x2), want, "chunked", 1e-13)


@pytest.mark.parametrize("case", list(CASES))
def test_one_sweep_matches(toy, case):
    preset, kw = CASES[case]
    jc, pc = _cfgs(preset, **kw)
    I1, I2 = (toy["I1"], toy["I2"]) if preset != "super_entropy" else shifted_pair(32, 40)[:2]
    jp, pp = _problems(jc, I1, I2)
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), I1.shape)
    j1, jaux = jax.jit(jg.make_sweep(jc, I1.shape))(jp, js)
    p1, paux = pg.make_sweep(pc, I1.shape)(pp, port_state(js))
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("case", ["full_mixture", "tpu_fast"])
def test_segment_matches(toy, case):
    # 30 sweeps at corr_tor = 0.99, where two f64 summation orders stay
    # together (ROADMAP Queue 3, P1)
    preset, kw = CASES[case]
    jc, pc = _cfgs(preset, tor=0.0, corr_tor=0.99, **kw)
    jp, pp = _problems(jc, toy["I1"], toy["I2"])
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE)
    jst, jn, jeb, jpb, jsb, _ = jg.make_segment_runner(jc, SHAPE)(jp, js, 30)
    pst, pn, peb, ppb, psb, _ = pg.make_segment_runner(pc, SHAPE)(pp, port_state(js), 30)
    assert pn == int(jn) == 30
    assert_fields_close(pst, jst, 1e-8, 1e-8, FIELDS)
    for g, w in ((peb, jeb), (ppb, jpb), (psb, jsb)):
        assert_close(g[:30], np.asarray(w)[:30], 1e-8, 0)


def test_solve_matches_and_launches_no_kernel_on_the_cpu(toy):
    # solve's own make_problem (site-major field from the port's build) and
    # readouts against JAX's, from the JAX init; no kernel on CPU tensors
    preset, kw = CASES["full_mixture"]
    jc, pc = _cfgs(preset, tor=0.0, corr_tor=0.99, **{**kw, "its": 30, "eval_every": 15})
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), SHAPE)
    before = [k.launches for k in KERNELS]
    jr = jg.solve(jc, toy["I1"], toy["I2"], gt_flow=toy["gt"], init=js,
                  flow_range=gqmap_tpu.FlowRange(*FR))
    pr = gqmap_tpu_torch.solve(pc, toy["I1"], toy["I2"], gt_flow=toy["gt"],
                               init=port_state(js), flow_range=gqmap_tpu_torch.FlowRange(*FR),
                               device="cpu")
    assert [k.launches for k in KERNELS] == before == [0, 0, 0]
    evals = [i for i in range(30) if np.isfinite(jr.AEPE[i])]
    assert evals == [i for i in range(30) if np.isfinite(pr.AEPE[i])] == [0, 14, 29]
    for name in ("AEPE", "logP"):
        assert_close(getattr(pr, name)[evals], getattr(jr, name)[evals], 1e-8, 0, name)
    assert_close(pr.Energy, jr.Energy, 1e-8, 0, "Energy")
    assert_close(pr.mu, jr.mu, 1e-8, 1e-8, "mu")
    assert pr.AEPE[29] < pr.AEPE[0]


def test_logp_matches(toy):
    # logP reads the chebyshev term as the bicubic one, as JAX's does
    jc, pc = _cfgs("full_mixture", **SPECTRAL)
    jp, pp = _problems(jc, toy["I1"], toy["I2"])
    flow = np.random.default_rng(3).uniform(-2, 2, SHAPE + (2,))
    want = jg.make_logp_fn(jc, SHAPE)(jp, jnp.asarray(flow))
    assert_close(pg.make_logp_fn(pc, SHAPE)(pp, t(flow)), want, 1e-10, 0, "logP")
    bicubic = gqmap_tpu_torch.GQMAPConfig.full_mixture(dtype="float64")
    bic = pg.make_logp_fn(bicubic, SHAPE)(pp, t(flow))
    assert float(bic) == float(pg.make_logp_fn(pc, SHAPE)(pp, t(flow)))


def test_make_problem_needs_the_flow_range(toy):
    _, pc = _cfgs("full_mixture", **SPECTRAL)
    with pytest.raises(ValueError, match="chebyshev' needs flow_range"):
        pg.make_problem(pc, toy["I1"], toy["I2"], device="cpu")


# --- twins of the JAX package's tests of the term ---------------------------------

def _node_values(cfg, I1, I2, x1, x2):
    p = pg.make_problem(cfg, I1, I2, gqmap_tpu_torch.FlowRange(-2, 2, -2, 2), device="cpu")
    return pg._node_f(cfg, p)(t(x1), t(x2)).numpy()


def test_chebyshev_data_term_close_to_exact():
    # twin of tests/test_solver.py::test_chebyshev_data_term_close_to_exact
    I1, I2, gt = shifted_pair(24, 32)
    C = gqmap_tpu_torch.GQMAPConfig
    cfg_ex = C.single_gaussian(K=5, dtype="float64")
    cfg_ch = C.single_gaussian(K=5, dtype="float64", data_term="chebyshev", cheb_p=48,
                               cheb_q=48, cheb_margin=1.0)
    r = np.random.default_rng(0)
    x1 = r.uniform(-2.5, 2.5, (3, 1, 24, 32))
    x2 = r.uniform(-2.5, 2.5, (3, 1, 24, 32))
    ve = _node_values(cfg_ex, I1, I2, x1, x2)
    vc = _node_values(cfg_ch, I1, I2, x1, x2)
    assert np.abs(ve - vc).mean() / np.abs(ve).max() < 0.01
    cfg_run = C.single_gaussian(K=5, its=10, eval_every=5, dtype="float64",
                                data_term="chebyshev", cheb_p=32, cheb_q=32)
    res = gqmap_tpu_torch.solve(cfg_run, I1, I2, gt_flow=gt,
                                flow_range=gqmap_tpu_torch.FlowRange(-2, 2, -2, 2), device="cpu")
    assert np.isfinite(res.Energy[:10]).all()


def test_chebyshev_super_patch():
    # twin of tests/test_solver.py::test_chebyshev_super_patch
    I1, I2, _ = shifted_pair(32, 40)
    C = gqmap_tpu_torch.GQMAPConfig
    cfg_ex = C.super_entropy(K=3, dtype="float64")
    cfg_ch = C.super_entropy(K=3, dtype="float64", data_term="chebyshev", cheb_p=48, cheb_q=48,
                             cheb_margin=1.0)
    r = np.random.default_rng(0)
    x1 = r.uniform(-2, 2, (2, 1, 8, 10))
    x2 = r.uniform(-2, 2, (2, 1, 8, 10))
    ve = _node_values(cfg_ex, I1, I2, x1, x2)
    vc = _node_values(cfg_ch, I1, I2, x1, x2)
    assert np.abs(ve - vc).mean() / np.abs(ve).max() < 0.01


def test_windowed_spectral_matches_direct():
    # twin of tests/test_legacy_modes.py::test_windowed_spectral_matches_direct[chebyshev]
    I1, I2, _ = shifted_pair(16, 20)
    C = gqmap_tpu_torch.GQMAPConfig
    cfg_d = C.legacy_v2(K=3, dtype="float64", window_rg=2, data_term="bicubic")
    cfg_s = C.legacy_v2(K=3, dtype="float64", window_rg=2, data_term="chebyshev", cheb_p=48,
                        cheb_q=48, cheb_margin=1.0)
    r = np.random.default_rng(0)
    x1 = r.uniform(-2, 2, (16, 20))
    x2 = r.uniform(-2, 2, (16, 20))
    vd = _node_values(cfg_d, I1, I2, x1, x2)
    vs = _node_values(cfg_s, I1, I2, x1, x2)
    assert np.abs(vs - vd).mean() / np.abs(vd).max() < 0.01


def test_cosine_solver_improves_and_tracks_chebyshev():
    # twin of tests/test_cosine.py::test_cosine_solver_improves_and_tracks_chebyshev
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (28, 36))
    k = np.ones(5) / 5
    I1 = np.apply_along_axis(lambda x: np.convolve(x, k, "same"), 0, I1)
    I1 = np.apply_along_axis(lambda x: np.convolve(x, k, "same"), 1, I1)
    I2 = np.roll(I1, 1, axis=1)
    gt = np.zeros((28, 36, 2))
    gt[..., 0] = 1.0
    fr = gqmap_tpu_torch.FlowRange(-2.0, 2.0, -2.0, 2.0)
    aepes = {}
    for dt in ("cosine", "chebyshev"):
        cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(
            dtype="float64", data_term=dt, cheb_p=24, cheb_q=24, its=600, eval_every=600,
            edge_quad="reduced")
        problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
        state = pg.init_state(cfg, fr, I1.shape, device="cpu")
        state, n, *_ = pg.make_segment_runner(cfg, I1.shape)(problem, state, 600)
        flow = pg.make_map_fn(cfg)(state).numpy()
        aepes[dt] = pg.aepe_of(cfg, flow, gt, np.zeros((28, 36), bool))
    # both must clearly beat the random-init AEPE (~1.5 over a +-2 box)
    assert aepes["cosine"] < 0.7, aepes
    assert abs(aepes["cosine"] - aepes["chebyshev"]) < 0.25, aepes
