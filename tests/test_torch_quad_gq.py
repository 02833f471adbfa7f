"""Kernels K10 and K11's module (``kernels/quad_gq.py``): the legacy quadratic
family's tensor-rule sums against the JAX package.

The JAX package runs ``gq_accumulate`` on ``make_node_pot_quadratic`` (K10's
function) and on ``make_edge_pot_truncquad`` (K11's) as XLA scans. Here the
port's plain versions, and torch float64 transcriptions of the kernels'
per-site arithmetic (``k10_transcribed``: the column and row terms of
``fu - x1`` and ``fv - x2``, the points row by row, Zc and Zr, the scale
last; ``k11_transcribed``: ``d`` formed as the plain version forms it, the
same sums), are held to it in float64 at 1e-10 of each sum's largest
magnitude plus 1e-12 absolute (Sm can be rounding noise), from numpy seeds:
the init, warm and |rho|-clamp probes, and for the edges the cutoff probe,
every sample within 1e-13 of ``|d| = dta``. Then ``legacy_v1``'s sweep with
the transcriptions routed in against JAX's sweep, the routes
(``_node_kernel``, ``_edge_kernel``, ``check_supported``), the rule and the
work counts. The kernels themselves run on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, port_state, shifted_pair, t
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.ops.gq import gq_accumulate as jax_gq_accumulate
from gqmap_tpu.ops.potentials import make_edge_pot_truncquad as jax_truncquad
from gqmap_tpu.ops.potentials import make_node_pot_quadratic as jax_quadratic
from gqmap_tpu.ops.quadrature import build_table as jax_build_table
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, quad_gq, roofline
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops.gq import GQRaw

TOL, FLOOR = 1e-10, 1e-12
PROBES = ("init", "warm", "clamp")
FR = (-2.0, 2.0, -2.0, 2.0)
FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")


def _close(got: GQRaw, want, name=""):
    for f in GQRaw._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f)
        assert tuple(g.shape) == w.shape, (name, f)
        assert_close(g, w, 0, TOL * np.abs(w).max() + FLOOR, f"{name} {f}")


def _sites(probe, shape, r):
    """muu, muv, su, sv, p of ``shape`` for a probe: the init (means over
    the flow range, wide sigma, zero correlation), warm (sigma in [0.01, 3],
    |p| <= 0.9) or the clamp (|p| = 0.99999, the corr_tor corner)."""
    muu, muv = r.uniform(-10, 2, shape), r.uniform(-2, 2, shape)
    if probe == "init":
        return muu, muv, r.uniform(12, 13, shape), r.uniform(4, 5, shape), np.zeros(shape)
    su, sv = r.uniform(0.01, 3, shape), r.uniform(0.01, 3, shape)
    if probe == "warm":
        return muu, muv, su, sv, r.uniform(-0.9, 0.9, shape)
    return muu, muv, su, sv, 0.99999 * np.where(r.uniform(size=shape) < 0.5, -1.0, 1.0)


def _edge_inputs(probe, K, dta, L=3, M=8, N=16, seed=0):
    """mu, sg (C, L, M, N), u2e, o2e, rou (D, C, L, M, N): the neighbour
    stacks of the state, or for the cutoff probe neighbour means at
    +-dta from endpoint 1's, jittered by 1e-13, and sigmas under 1e-12, so
    every sample's d lies within ~1e-13 of the cutoff."""
    r = np.random.default_rng(seed + K)
    edge = (2, 2, L, M, N)
    if probe == "cutoff":
        mu = r.uniform(-3, 3, (2, L, M, N))
        side = np.where(r.uniform(size=edge) < 0.5, -1.0, 1.0)
        u2e = mu[None] + side * dta + r.uniform(-1e-13, 1e-13, edge)
        sg = r.uniform(1e-14, 1e-12, (2, L, M, N))
        return mu, sg, u2e, r.uniform(1e-14, 1e-12, edge), r.uniform(-0.9, 0.9, edge)
    muu, muv, su, sv, _ = _sites(probe, (L, M, N), r)
    mu, sg = np.stack([muu, muv]), np.stack([su, sv])
    u2e = np.stack([np.roll(mu, -1, -2), np.roll(mu, -1, -1)])
    o2e = np.stack([np.roll(sg, -1, -2), np.roll(sg, -1, -1)])
    if probe == "init":
        rou = np.zeros(edge)
    elif probe == "warm":
        rou = r.uniform(-0.9, 0.9, edge)
    else:
        rou = 0.99999 * np.where(r.uniform(size=edge) < 0.5, -1.0, 1.0)
    return mu, sg, u2e, o2e, rou


def _whitening(p):
    sp, sm = torch.sqrt(1.0 + p), torch.sqrt(1.0 - p)
    return (sp + sm) * 0.5, (sp - sm) * 0.5


def k10_transcribed(prior, muu, muv, su, sv, pn, K, var):
    """K10's per-site arithmetic (``csrc/quad_gq.cu``, quad_node_kernel) in
    torch: a = fu - u1, b = fv - u2, the column terms a - o1e s x_c and
    b - o2e t x_c less the row terms o1e t x_r and o2e s x_r, the points row
    by row, Zc = sum fv x_c and Zr = sum fv x_r, the scale -1/(2 var) last."""
    v = torch.as_tensor(quad_gq.rule_values(K), dtype=muu.dtype)
    x = v[:K]
    w, wxixj, wx2a, wx2m = v[K:].reshape(4, K * K)
    s, tt = _whitening(pn)
    o1e, o2e = su * math.sqrt(2.0), sv * math.sqrt(2.0)
    a, b = prior[..., 0] - muu, prior[..., 1] - muv
    o1s, o1t, o2s, o2t = o1e * s, o1e * tt, o2e * s, o2e * tt
    e = zc = zr = sa = sm = sxy = torch.zeros_like(muu)
    for r in range(K):
        for c in range(K):
            i = r * K + c
            du = (a - o1s * x[c]) - o1t * x[r]
            dv = (b - o2t * x[c]) - o2s * x[r]
            g = du * du + dv * dv
            fv = w[i] * g
            e, zc, zr = e + fv, zc + fv * x[c], zr + fv * x[r]
            sa, sm, sxy = sa + wx2a[i] * g, sm + wx2m[i] * g, sxy + wxixj[i] * g
    k = -1.0 / (2.0 * var)
    return GQRaw(k * e, k * (s * zc + tt * zr), k * (tt * zc + s * zr), k * sa, k * sm, k * sxy)


def k11_transcribed(mu, sg, u2e, o2e, rou, K, gama, dta):
    """K11's per-element arithmetic (truncquad_edge_kernel) in torch: d formed
    as the plain version forms it (z_i = s x_c + t x_r, x1 = o1e z_i + u1,
    x2 = o2e z_j + u2, d = x2 - x1), zero beyond dta, the points row by row,
    the sums of :func:`k10_transcribed`, the scale -1/(2 gama) last."""
    v = torch.as_tensor(quad_gq.rule_values(K), dtype=mu.dtype)
    x = v[:K]
    w, wxixj, wx2a, wx2m = v[K:].reshape(4, K * K)
    s, tt = _whitening(rou)
    o1e, o2e2 = sg[None] * math.sqrt(2.0), o2e * math.sqrt(2.0)
    u1 = mu[None]
    e = zc = zr = sa = sm = sxy = torch.zeros_like(rou)
    for r in range(K):
        for c in range(K):
            i = r * K + c
            zi, zj = s * x[c] + tt * x[r], tt * x[c] + s * x[r]
            d = (o2e2 * zj + u2e) - (o1e * zi + u1)
            d = torch.where(d.abs() > dta, torch.zeros_like(d), d)
            g = d * d
            fv = w[i] * g
            e, zc, zr = e + fv, zc + fv * x[c], zr + fv * x[r]
            sa, sm, sxy = sa + wx2a[i] * g, sm + wx2m[i] * g, sxy + wxixj[i] * g
    k = -1.0 / (2.0 * gama)
    return GQRaw(k * e, k * (s * zc + tt * zr), k * (tt * zc + s * zr), k * sa, k * sm, k * sxy)


VERSIONS = {"plain": (quad_gq.quad_node_gq_torch, quad_gq.truncquad_edge_gq_torch),
            "kernel transcribed": (k10_transcribed, k11_transcribed)}


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("L, M, N", [(1, 24, 28), (3, 24, 28), (20, 12, 14)])
def test_quad_node_sums_match_jax(L, M, N, probe, version):
    # legacy_v1's K = 9 and quad_var at L = 1, a mixture's L = 3 and the
    # update phase's L = 20; the prior over the flow range. At the init (p =
    # 0) Sxy is zero in exact arithmetic and both sides are rounding noise of
    # Ei's size, ~1e-13 here (the absolute floor)
    r = np.random.default_rng(L * M + N)
    site = _sites(probe, (L, M, N), r)
    prior = r.uniform(-10, 2, (M, N, 2))
    want = jax_gq_accumulate(jax_quadratic(jnp.asarray(prior), 1.0),
                             *(jnp.asarray(a) for a in site), jax_build_table(9, 0, np.float64))
    got = VERSIONS[version][0](t(prior), *map(t, site), 9, 1.0)
    _close(got, want, f"K10 {version} {probe}")


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("probe", PROBES + ("cutoff",))
@pytest.mark.parametrize("gama, dta", [(1.0, 10.0), (1.3, 0.5)])
@pytest.mark.parametrize("K", [5, 9])
def test_truncquad_edge_sums_match_jax(K, gama, dta, probe, version):
    # legacy_v1's (gama, dta) = (1, 10), and (1.3, 0.5), where most samples
    # lie beyond the cutoff
    mu, sg, u2e, o2e, rou = _edge_inputs(probe, K, dta)
    j = [jnp.asarray(a) for a in (mu, sg, u2e, o2e, rou)]
    want = jax_gq_accumulate(jax_truncquad(gama, dta), j[0][None], j[2], j[1][None], j[3], j[4],
                             jax_build_table(K, 0, np.float64))
    got = VERSIONS[version][1](*map(t, (mu, sg, u2e, o2e, rou)), K, gama, dta)
    _close(got, want, f"K11 {version} {probe}")
    if probe == "cutoff":
        # every sample within ~1e-13 of |d| = dta: about half are truncated
        inside = np.asarray(want.Ei) / (-dta * dta / (2 * gama) * np.pi)
        assert 0.2 < inside.mean() < 0.8, inside.mean()


@pytest.mark.parametrize("version", list(VERSIONS))
def test_quad_node_sums_on_a_shards_block(version):
    # a shard's block: its sites and the prior's block, a view with the whole
    # prior's strides, give the whole lattice's sums there
    r = np.random.default_rng(5)
    site = [t(a) for a in _sites("warm", (2, 12, 14), r)]
    prior = t(r.uniform(-10, 2, (12, 14, 2)))
    fn = VERSIONS[version][0]
    whole = fn(prior, *site, 9, 0.05)
    block = (slice(None), slice(3, 9), slice(5, 12))
    got = fn(prior[3:9, 5:12], *(x[block].contiguous() for x in site), 9, 0.05)
    for a, b in zip(got, whole):
        assert_close(a, b[block].numpy(), 0, TOL * float(b.abs().max()) + FLOOR)


def test_plain_versions_step_quad_chunk_points_at_a_time():
    # the sweep's plain route steps cfg.quad_chunk points at a time
    r = np.random.default_rng(2)
    site = [t(a) for a in _sites("warm", (1, 6, 7), r)]
    prior = t(r.uniform(-10, 2, (6, 7, 2)))
    for a, b in zip(quad_gq.quad_node_gq_torch(prior, *site, 9, 1.0, quad_chunk=27),
                    quad_gq.quad_node_gq_torch(prior, *site, 9, 1.0)):
        assert_close(a, b.numpy(), 0, TOL * float(b.abs().max()) + FLOOR)
    args = [t(a) for a in _edge_inputs("warm", 9, 10.0, L=1, M=6, N=7)]
    for a, b in zip(quad_gq.truncquad_edge_gq_torch(*args, 9, 1.0, 10.0, quad_chunk=27),
                    quad_gq.truncquad_edge_gq_torch(*args, 9, 1.0, 10.0)):
        assert_close(a, b.numpy(), 0, TOL * float(b.abs().max()) + FLOOR)


@pytest.mark.parametrize("K", [5, 9, 17])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rule_values_are_the_plain_tables(K, dtype):
    # the nodes rounded to the type are the table's XI (column) and XJ (row)
    # bit for bit, WIWJ the table's, and the weighted monomials the JAX
    # package's table's
    got = quad_gq.rule_values(K, dtype)
    assert got.dtype == dtype and got.shape == (K + 4 * K * K,)
    x = got[:K]
    w, wxixj, wx2a, wx2m = got[K:].reshape(4, K * K)
    tab = jax_build_table(K, 0, dtype)
    np.testing.assert_array_equal(np.tile(x, K), tab.xi.reshape(-1))
    np.testing.assert_array_equal(np.repeat(x, K), tab.xj.reshape(-1))
    np.testing.assert_array_equal(w, tab.wiwj.reshape(-1))
    t64 = jax_build_table(K, 0, np.float64)
    tol = 1e-6 if dtype == np.float32 else 1e-15
    for got_row, want_row in ((wxixj, t64.wiwj * t64.xixj), (wx2a, t64.wiwj * (t64.x2a - 1)),
                              (wx2m, t64.wiwj * t64.x2m)):
        np.testing.assert_allclose(got_row, want_row.reshape(-1), rtol=tol, atol=tol * 1e-3)


def _problems(cfg_kw):
    jc = gqmap_tpu.GQMAPConfig.legacy_v1(**cfg_kw)
    pc = gqmap_tpu_torch.GQMAPConfig.legacy_v1(**cfg_kw)
    I1, I2, _ = shifted_pair(24, 28)
    prior = np.random.default_rng(9).uniform(-1, 2, (24, 28, 2))
    jp = jg.make_problem(jc, I1, I2, gqmap_tpu.FlowRange(*FR))._replace(
        init_flow=jnp.asarray(prior))
    pp = problem_from_numpy(dict(I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
                                 interior=np.asarray(jp.interior), rng=tuple(jp.rng), cheb=None,
                                 init_flow=prior), device="cpu")
    return jc, pc, jp, pp


@pytest.mark.parametrize("quad_var", [1.0, 0.05])
def test_legacy_v1_sweep_through_the_transcribed_kernels_matches_jax(quad_var, monkeypatch):
    # the route make_sweep takes for "auto" (K10 on the quadratic prior, K11
    # on the truncated-quadratic tensor edges), here the kernels'
    # transcriptions: one sweep at legacy_v1's own K = 9 against JAX's, with
    # the preset's quad_var and the chip's 0.05
    calls = []

    def route(fn):
        def run(*args, quad_chunk=0):
            calls.append(fn.__name__)
            return fn(*args)
        return run

    monkeypatch.setitem(pg._NODE_QUAD, "auto", route(k10_transcribed))
    monkeypatch.setitem(pg._EDGE_ROUTES["K11"], "auto", route(k11_transcribed))
    jc, pc, jp, pp = _problems(dict(dtype="float64", its=2, eval_every=2, quad_var=quad_var))
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), (24, 28))
    j1, jaux = jax.jit(jg.make_sweep(jc, (24, 28)))(jp, js)
    p1, paux = pg.make_sweep(pc, (24, 28))(pp, port_state(js))
    assert calls == ["k10_transcribed", "k11_transcribed"]
    for f in FIELDS:
        assert_close(getattr(p1, f), np.asarray(getattr(j1, f)), 1e-10, 1e-12, f)
    for f in paux._fields:
        assert_close(getattr(paux, f), np.asarray(getattr(jaux, f)), 1e-10, 1e-12, f)


def test_legacy_v1_routes_take_k10_and_k11():
    C = gqmap_tpu_torch.GQMAPConfig
    assert pg._node_kernel(C.legacy_v1()) == "K10"
    assert pg._edge_kernel(C.legacy_v1()) == "K11"
    assert pg._edge_kernel(C.legacy_v1(edge_quad="reduced")) is None
    assert pg._edge_kernel(C.full_mixture()) == "K3" and pg._edge_kernel(C.tpu_fast()) == "K2"
    assert pg._node_kernel(C.full_mixture(data_term="quadratic")) == "K10"
    # "cuda" is a kernel on both terms of legacy_v1 and of its quad_var 0.05
    for kw in ({}, dict(quad_var=0.05)):
        pg.check_supported(C.legacy_v1(node_kernel="cuda", edge_kernel="cuda", **kw))


@pytest.mark.parametrize("override, match", [
    (dict(edge_quad="reduced", edge_kernel="cuda"), "kernel K11"),
    (dict(gradient_estimator="autodiff", edge_kernel="cuda"), "kernel K11"),
    (dict(gradient_estimator="autodiff", node_kernel="cuda"), "kernel K10"),
])
def test_legacy_v1_cuda_route_without_a_kernel_raises(override, match):
    # the reduced truncated-quadratic edges stay plain, and autodiff
    # differentiates plain sums: "cuda" raises there, "auto" and "torch" run
    with pytest.raises(ValueError, match=match):
        pg.check_supported(gqmap_tpu_torch.GQMAPConfig.legacy_v1(**override))
    for route in ("auto", "torch"):
        kw = {k: (route if k.endswith("_kernel") else v) for k, v in override.items()}
        pg.check_supported(gqmap_tpu_torch.GQMAPConfig.legacy_v1(**kw))


@pytest.mark.parametrize("override, wrapper", [(dict(node_kernel="cuda"), "quad_node_gq_cuda"),
                                               (dict(edge_kernel="cuda"),
                                                "truncquad_edge_gq_cuda")])
def test_cpu_sweep_routes_legacy_v1_through_its_kernels(override, wrapper):
    # "cuda" sends the prior to K10 and the edges to K11, which refuse CPU
    # tensors rather than fall back; "auto" runs their plain versions there,
    # bit for bit "torch"'s, and launches nothing
    C = gqmap_tpu_torch.GQMAPConfig.legacy_v1
    _, _, _, problem = _problems(dict(dtype="float64"))
    cfg = C(dtype="float64")
    state = pg.init_state(cfg, gqmap_tpu_torch.FlowRange(*FR), (24, 28), device="cpu")
    before = [k.launches for k in COUNTED]
    with pytest.raises(RuntimeError, match=f"{wrapper} needs CUDA"):
        pg.make_sweep(C(dtype="float64", **override), (24, 28))(problem, state)
    a, aux_a = pg.make_sweep(cfg, (24, 28))(problem, state)
    plain = {k: "torch" for k in override}
    b, aux_b = pg.make_sweep(C(dtype="float64", **plain), (24, 28))(problem, state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(aux_a, aux_b))
    assert [k.launches for k in COUNTED] == before == [0] * len(COUNTED)
    assert quad_gq.quad_node_gq_cuda in COUNTED and quad_gq.truncquad_edge_gq_cuda in COUNTED


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 4, 5), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="quad_node_gq_cuda needs CUDA"):
        quad_gq.quad_node_gq_cuda(torch.zeros((4, 5, 2), dtype=torch.float64), x, x, x, x, x, 9,
                                  1.0)
    mu = torch.zeros((2, 1, 4, 5), dtype=torch.float64)
    e = torch.zeros((2, 2, 1, 4, 5), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="truncquad_edge_gq_cuda needs CUDA"):
        quad_gq.truncquad_edge_gq_cuda(mu, mu, e, e, e, 9, 1.0, 10.0)


def test_work_counts():
    # k10_work: 5 site fields, the (M, N, 2) prior and 6 sums; k11_work: K3's
    # bytes (mu, sigma, rho, 6 sums); operations from FLOPS, two roots a site
    # or an element
    F = roofline.FLOPS
    w10 = roofline.k10_work((2, 3, 4), 9)
    assert w10["bytes"] == (5 * 24 + 2 * 12 + 6 * 24) * 4 and w10["roots"] == 48
    assert w10["flops"] == 24 * (81 * F["K10 point"] + 9 * F["K10 node"] + F["K10 site"])
    w11 = roofline.k11_work((2, 2, 1, 3, 4), 5, itemsize=8)
    assert w11["bytes"] == 8 * 48 * 8 and w11["roots"] == 96
    assert w11["flops"] == 48 * (25 * F["K11 point"] + 5 * F["K11 node"] + F["K11 site"])
    assert w11 == {**roofline.k3_work((2, 2, 1, 3, 4), 5, itemsize=8),
                   "flops": w11["flops"], "roots": 96}
