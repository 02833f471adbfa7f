"""The port's plain operators against the JAX package's, in float64.

Tolerance: about 1e-10 relative for single calls (float64 round-off with a
different summation order), unless a test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_common import assert_close, assert_fields_close, t
from gqmap_tpu.ops import flowviz as jflowviz
from gqmap_tpu.ops import gq as jgq
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import mixture as jmixture
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops import quadrature as jquad
from gqmap_tpu.ops import simplex as jsimplex
from gqmap_tpu_torch.ops import flowviz, gq, interp, mixture, potentials, quadrature, simplex

RTOL, ATOL = 1e-10, 1e-12


@pytest.mark.parametrize("K", [2, 5, 13, 21])
def test_gauss_hermite_tables_match(K):
    x, w = quadrature.gauss_hermite(K)
    jx, jw = jquad.gauss_hermite(K)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(w, jw)
    for chunk in (0, 4):
        a = quadrature.build_table_1d(K, chunk, np.float64)
        b = jquad.build_table_1d(K, chunk, np.float64)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.w, b.w)


def test_pad_cubic_matches():
    V = np.random.default_rng(0).uniform(0, 255, (9, 13))
    assert_close(interp.pad_cubic(t(V)), jinterp.pad_cubic(jnp.asarray(V)), RTOL, ATOL)


def test_sample_bicubic_matches_including_clamp():
    r = np.random.default_rng(1)
    V = r.uniform(0, 255, (11, 14))
    VV = jinterp.pad_cubic(jnp.asarray(V))
    # fractional points, points beyond every edge (the clamp of
    # gqmap_gpu_mixture.m:157-161) and exact 1-based grid points
    Xq = np.concatenate([r.uniform(-3, 17, 200), [1.0, 14.0, 13.0, 7.0]])
    Yq = np.concatenate([r.uniform(-3, 14, 200), [1.0, 11.0, 10.0, 4.0]])
    got = interp.sample_bicubic(t(VV), t(Xq), t(Yq))
    assert_close(got, jinterp.sample_bicubic(VV, jnp.asarray(Xq), jnp.asarray(Yq)), RTOL, ATOL)
    # a query at (j, i) returns V[i-1, j-1] exactly
    np.testing.assert_allclose(got.numpy()[-4:], V[[0, 10, 9, 3], [0, 13, 12, 6]],
                               rtol=1e-12)


def test_node_potential_matches():
    r = np.random.default_rng(2)
    I1 = r.uniform(0, 255, (8, 10))
    VV = jinterp.pad_cubic(jnp.asarray(r.uniform(0, 255, (8, 10))))
    x1 = r.uniform(-2, 2, (3, 8, 10))
    x2 = r.uniform(-2, 2, (3, 8, 10))
    want = jpot.make_node_pot_bicubic(jnp.asarray(I1), VV, 1.0, 1e-6)(jnp.asarray(x1),
                                                                      jnp.asarray(x2))
    got = potentials.make_node_pot_bicubic(t(I1), t(VV), 1.0, 1e-6)(t(x1), t(x2))
    assert_close(got, want, RTOL, ATOL)


def _edge_sites(seed, shape=(2, 2, 3, 5, 7)):
    r = np.random.default_rng(seed)
    return (r.normal(size=shape[2:])[None, None], r.normal(size=shape),
            r.uniform(0.05, 3, shape[2:])[None, None], r.uniform(0.05, 3, shape),
            r.uniform(-0.999, 0.999, shape))


def test_reduced_quadrature_and_finalize_match():
    u1, u2, o1, o2, p = _edge_sites(3)
    tab = jquad.build_table_1d(13, dtype=np.float64)
    want = jgq.gq_accumulate_diff(jpot.make_edge_pot_diff(5.0, 1e-6),
                                  *map(jnp.asarray, (u1, u2, o1, o2, p)), tab)
    got = gq.gq_accumulate_diff(potentials.make_edge_pot_diff(5.0, 1e-6),
                                *map(t, (u1, u2, o1, o2, p)), tab)
    assert_fields_close(got, want, RTOL, ATOL)
    a = np.array([0.5, 0.3, 0.2]).reshape(3, 1, 1)
    for T in (0.0, 0.17):
        fw = jgq.finalize(want, jnp.asarray(a), jnp.asarray(o1), jnp.asarray(o2),
                          jnp.asarray(p), T, jgq.EDGE)
        fg = gq.finalize(got, t(a), t(o1), t(o2), t(p), T, gq.EDGE)
        assert_fields_close(fg, fw, RTOL, ATOL)


def test_finalize_closed_matches():
    r = np.random.default_rng(4)
    shape = (3, 4, 5)
    args = [r.normal(size=shape) for _ in range(6)]
    a = np.array([0.2, 0.5, 0.3]).reshape(3, 1, 1)
    o1, o2 = r.uniform(0.01, 5, shape), r.uniform(0.01, 5, shape)
    p = r.uniform(-0.99999, 0.99999, shape)
    want = jgq.finalize_closed(*map(jnp.asarray, args + [a, o1, o2, p]), 0.3, jgq.NODE)
    got = gq.finalize_closed(*map(t, args + [a, o1, o2, p]), 0.3, gq.NODE)
    assert_fields_close(got, want, RTOL, ATOL)


def test_softmax_and_natural_step_match():
    r = np.random.default_rng(5)
    w, dalpha = r.normal(size=3) * 4, r.normal(size=3) * 1e6
    assert_close(simplex.softmax(t(w)), jsimplex.softmax(jnp.asarray(w)), RTOL, 1e-15)
    for lr in (1e-8, 1e-3, 10.0):  # the last one hits the +-300 logit clamp
        assert_close(simplex.softmax_natural_step(t(w), t(dalpha), lr),
                     jsimplex.softmax_natural_step(jnp.asarray(w), jnp.asarray(dalpha), lr),
                     RTOL, ATOL)


def test_project_simplex_matches():
    r = np.random.default_rng(6)
    y = np.concatenate([r.normal(size=(40, 4)) * 2, np.full((1, 4), 0.25),
                        [[3.0, -1.0, -1.0, -1.0]]])
    assert_close(simplex.project_simplex(t(y)), jsimplex.project_simplex(jnp.asarray(y)),
                 RTOL, ATOL)


@pytest.mark.parametrize("L", [1, 3])
def test_extract_map_matches(L):
    r = np.random.default_rng(7 + L)
    muu, muv = r.uniform(-2, 2, (L, 6, 7)), r.uniform(-2, 2, (L, 6, 7))
    su, sv = r.uniform(0.05, 2, (L, 6, 7)), r.uniform(0.05, 2, (L, 6, 7))
    alpha = r.dirichlet(np.ones(L))
    want = jmixture.extract_map(*map(jnp.asarray, (alpha, muu, su, muv, sv)))
    got = mixture.extract_map(*map(t, (alpha, muu, su, muv, sv)))
    # the golden-section bracket closes to ~sqrt(eps) of the mode, where the
    # two packages' comparisons of equal pdf values may branch differently
    assert_close(got, want, 0, 1e-7)


def test_flow_to_color_is_the_jax_copy():
    r = np.random.default_rng(8)
    flow = r.normal(size=(9, 11, 2)) * 3
    flow[2, 3, 0] = 1e10  # unknown pixel
    got, want = flowviz.flow_to_color(flow), jflowviz.flow_to_color(flow)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---- D3: a NaN query gives what the JAX package gives (ROADMAP Queue 3)

def _nan_queries(M=8, N=9, seed=7):
    r = np.random.default_rng(seed)
    x1 = r.uniform(-2, 2, (2, M, N))
    x2 = r.uniform(-2, 2, (2, M, N))
    x1[0, 2, 3] = np.nan          # column coordinate only
    x2[0, 4, 5] = np.nan          # row coordinate only
    x1[1, 0, 0] = x2[1, 0, 0] = np.nan  # both, at the corner
    x1[1, 7, 8] = np.nan          # the last pixel
    return x1, x2


def _same_with_nans(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_sample_bicubic_nan_query_gives_nan():
    V = np.random.default_rng(0).uniform(0, 1, (8, 9))
    VV = jinterp.pad_cubic(jnp.asarray(V))
    Xq, Yq = np.array([2.5, np.nan, 4.0, np.nan]), np.array([3.0, 2.0, np.nan, np.nan])
    got = interp.sample_bicubic(t(VV), t(Xq), t(Yq))
    want = jinterp.sample_bicubic(VV, jnp.asarray(Xq), jnp.asarray(Yq))
    _same_with_nans(got, want)
    assert np.isnan(got.numpy()[1:]).all() and np.isfinite(got.numpy()[0])


def test_interp2_linear_nan_query_matches():
    V = np.random.default_rng(1).uniform(0, 1, (8, 9))
    Xq, Yq = np.array([2.5, np.nan, 4.0]), np.array([3.0, 2.0, np.nan])
    _same_with_nans(interp.interp2_linear(t(V), t(Xq), t(Yq)),
                    jinterp.interp2_linear(jnp.asarray(V), jnp.asarray(Xq), jnp.asarray(Yq)))


@pytest.mark.parametrize("kind", ["bicubic", "nearest", "windowed_nearest", "windowed_bicubic",
                                  "chain"])
def test_node_potentials_nan_query_match(kind):
    # the nearest lookups read, at a NaN query, the element JAX's take reads
    # there (XLA converts a NaN index to 0); the bicubic sampler gives NaN
    r = np.random.default_rng(3)
    I1, I2 = r.uniform(0, 1, (8, 9)), r.uniform(0, 1, (8, 9))
    x1, x2 = _nan_queries()
    jI1, jI2 = jnp.asarray(I1), jnp.asarray(I2)
    up, pad = jinterp.upsample_cubic(jI2, 2), jinterp.pad_cubic(jI2)
    if kind == "bicubic":
        pair = (potentials.make_node_pot_bicubic(t(I1), t(pad), 1.0, 0.01),
                jpot.make_node_pot_bicubic(jI1, pad, 1.0, 0.01))
    elif kind == "nearest":
        pair = (potentials.make_node_pot_nearest(t(I1), t(up), 1.0, 0.01, 2),
                jpot.make_node_pot_nearest(jI1, up, 1.0, 0.01, 2))
    elif kind.startswith("windowed"):
        base = kind.split("_")[1]
        tab = up if base == "nearest" else pad
        pair = (potentials.make_node_pot_windowed(t(I1), t(tab), 1.0, 0.01, 1, base, 2),
                jpot.make_node_pot_windowed(jI1, tab, 1.0, 0.01, 1, base, 2))
    else:
        pair = (potentials.make_node_pot_nearest_chain(t(I1), t(up), t(2 * up), t(3 * up),
                                                       1.0, 0.01, 2),
                jpot.make_node_pot_nearest_chain(jI1, up, 2 * up, 3 * up, 1.0, 0.01, 2))
    got = pair[0](t(x1), t(x2))
    want = pair[1](jnp.asarray(x1), jnp.asarray(x2))
    for g, w in zip(got if kind == "chain" else [got], want if kind == "chain" else [want]):
        _same_with_nans(g, w)


def test_full_mixture_sweep_from_a_nan_mean_matches():
    # one f64 sweep on the 16x16 toy from a state with a NaN mean at one
    # interior site: the NaNs land where JAX's land, the finite values agree
    import jax

    import gqmap_tpu
    import gqmap_tpu_torch
    from _torch_common import port_state
    from gqmap_tpu.models import gqmap as jg
    from gqmap_tpu_torch.convert import problem_from_numpy
    from gqmap_tpu_torch.models import gqmap as pg
    from scipy.ndimage import gaussian_filter

    kw = dict(K=5, L=2, dtype="float64")
    jcfg = gqmap_tpu.GQMAPConfig.full_mixture(**kw)
    r = np.random.default_rng(0)
    I1 = gaussian_filter(r.uniform(0, 255, (16, 16)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    fr = gqmap_tpu.FlowRange(-2.0, 2.0, -2.0, 2.0)
    jp = jg.make_problem(jcfg, I1, I2)._replace(rng=fr)
    js = jg.init_state(jcfg, fr, I1.shape)
    js = js._replace(muu=js.muu.at[1, 6, 9].set(jnp.nan))
    want, waux = jax.jit(jg.make_sweep(jcfg, (16, 16)))(jp, js)
    pp = problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                 interior=np.asarray(jp.interior), rng=tuple(fr), cheb=None),
                            device="cpu")
    got, gaux = pg.make_sweep(gqmap_tpu_torch.GQMAPConfig.full_mixture(**kw), (16, 16))(
        pp, port_state(js))
    assert np.isnan(np.asarray(want.muu)).any()
    for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou", "w"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=f)
    for f in ("energy", "ptdmu"):
        _same_with_nans(getattr(gaux, f), getattr(waux, f))
