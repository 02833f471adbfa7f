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
from gqmap_tpu_torch.ops.quadrature import gauss_hermite

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


def k10_v2_transcribed(prior, muu, muv, su, sv, pn, K, var):
    """K10 v2's per-site arithmetic (quad_node_v2_kernel) in torch: a, b and
    the products of o1e, o2e with s, t; the six coefficients of
    (fu - x1)^2 + (fv - x2)^2 on (1, XI, XJ, XI^2, XI XJ, XJ^2); each sum
    T[i][0] c0 then T[i][j] c_j added in j's order; Z1, Z2; the scale."""
    T = torch.as_tensor(quad_gq.closed_form_table(K), dtype=muu.dtype)
    s, tt = _whitening(pn)
    o1e, o2e = su * math.sqrt(2.0), sv * math.sqrt(2.0)
    a, b = prior[..., 0] - muu, prior[..., 1] - muv
    o1s, o1t, o2s, o2t = o1e * s, o1e * tt, o2e * s, o2e * tt
    c = (a * a + b * b, -2.0 * (a * o1s + b * o2t), -2.0 * (a * o1t + b * o2s),
         o1s * o1s + o2t * o2t, 2.0 * (o1s * o1t + o2t * o2s), o1t * o1t + o2s * o2s)
    return _write(_closed_form(T, c), s, tt, -1.0 / (2.0 * var))


def _closed_form(T, c):
    out = []
    for i in range(6):
        acc = T[i, 0] * c[0]
        for j in range(1, 6):
            acc = acc + T[i, j] * c[j]
        out.append(acc)
    return out


def _write(sums, s, tt, k):
    e, zc, zr, sa, sm, sxy = sums
    return GQRaw(k * e, k * (s * zc + tt * zr), k * (tt * zc + s * zr), k * sa, k * sm, k * sxy)


INSIDE, OUTSIDE, MIXED = 1, 2, 3  # K11 v2's classes (quad_gq.cu)


def _reach(mu, sg, u2e, o2e, rou, K):
    """K11 v2's classifier terms: delta, alpha, beta (from the roots), the
    reach (|alpha| + |beta|) max|x| and the margin 16 eps (|u1| + |u2| +
    (o1e + o2e)(|s| + |t|) max|x|), and s, t."""
    xmax = float(np.abs(quad_gq.node_values(K, _NP[rou.dtype])[:K]).max())
    sp, sm = torch.sqrt(1.0 + rou), torch.sqrt(1.0 - rou)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    u1, o1e, o2e2 = mu[None], sg[None] * math.sqrt(2.0), o2e * math.sqrt(2.0)
    delta = u2e - u1
    dn, ds = o2e2 - o1e, o2e2 + o1e
    alpha, beta = (dn * sp - ds * sm) * 0.5, (dn * sp + ds * sm) * 0.5
    reach = (alpha.abs() + beta.abs()) * xmax
    eps = torch.finfo(rou.dtype).eps
    margin = 16 * eps * (u1.abs() + u2e.abs() + (o1e.abs() + o2e2.abs()) * (s.abs() + tt.abs())
                         * xmax)
    return delta, alpha, beta, reach, margin, s, tt


def k11_v2_classes(mu, sg, u2e, o2e, rou, K, dta):
    """K11 v2's class of each edge element: inside (every sample within
    the cutoff), outside (every one beyond it) or mixed (a NaN anywhere:
    both tests fail)."""
    delta, _, _, reach, margin, _, _ = _reach(mu, sg, u2e, o2e, rou, K)
    ad = delta.abs()
    cls = torch.full(delta.shape, MIXED, dtype=torch.int64)
    cls[ad - reach - margin > dta] = OUTSIDE
    cls[ad + reach + margin < dta] = INSIDE
    return cls


def _mixed_leaves(mu, sg, u2e, o2e, rou, K, dta, G):
    """The mixed forms' G leaves an element: leaf r the row r's six terms
    (d as the plain version forms it, zero beyond dta; A, B, C over the
    columns in order; Ei w_r A, Zc w_r B, Zr w_r x_r A, Sa w_r C +
    w_r (x_r^2 - 1) A, Sm w_r C - w_r x_r^2 A, Sxy w_r x_r B), zero past
    the last row: (G, 6) + the edge shape."""
    v = torch.as_tensor(quad_gq.node_values(K), dtype=rou.dtype)
    x, w, wx, wx2, wx2m1 = v.reshape(5, K)
    s, tt = _whitening(rou)
    o1e, o2e2 = sg[None] * math.sqrt(2.0), o2e * math.sqrt(2.0)
    u1 = mu[None]
    leaves = torch.zeros((G, 6) + rou.shape, dtype=rou.dtype)
    for r in range(K):
        A = B = C = torch.zeros_like(rou)
        for c in range(K):
            zi, zj = s * x[c] + tt * x[r], tt * x[c] + s * x[r]
            d = (o2e2 * zj + u2e) - (o1e * zi + u1)
            d = torch.where(d.abs() > dta, torch.zeros_like(d), d)
            g = d * d
            A, B, C = A + w[c] * g, B + wx[c] * g, C + wx2[c] * g
        wc = w[r] * C
        leaves[r] = torch.stack([w[r] * A, w[r] * B, wx[r] * A, wx2m1[r] * A + wc,
                                 -wx2[r] * A + wc, wx[r] * B])
    return leaves


def _pairwise(leaves, lo, n):
    """The per-lane form's tree: leaves lo .. lo + n - 1 summed pairwise."""
    if n == 1:
        return leaves[lo]
    return _pairwise(leaves, lo, n // 2) + _pairwise(leaves, lo + n // 2, n // 2)


def _xor_tree(leaves):
    """The cooperative form's tree: lane q of a group holds leaf q; at each
    offset 1, 2, ... a lane adds its partner's (lane q ^ off) value to its
    own; every lane ends with the sum. Returns lane 0's."""
    v = leaves.clone()
    G = v.shape[0]
    off = 1
    while off < G:
        v = v + v[torch.arange(G) ^ off]
        off <<= 1
    return v[0]


def k11_v2_transcribed(mu, sg, u2e, o2e, rou, K, gama, dta, coop_lanes=quad_gq.COOP_LANES,
                       forms=None):
    """K11 v2's per-element arithmetic (truncquad_edge_v2_kernel) in torch:
    the classes (:func:`k11_v2_classes`); inside, the closed form of
    c = (delta^2, 2 delta alpha, 2 delta beta, alpha^2, 2 alpha beta,
    beta^2); outside, zeros; mixed, the rows' leaves (:func:`_mixed_leaves`,
    G = 16 at K <= 16) summed by the cooperative form's xor tree in the warps
    (32 consecutive sites of a plane) with at most ``coop_lanes`` mixed
    elements, by the per-lane form's pairwise tree in the others. ``forms``
    (a dict) gets each form's sums of every element, the warps' choice and
    the classes."""
    T = torch.as_tensor(quad_gq.closed_form_table(K), dtype=rou.dtype)
    cls = k11_v2_classes(mu, sg, u2e, o2e, rou, K, dta)
    delta, alpha, beta, _, _, s, tt = _reach(mu, sg, u2e, o2e, rou, K)
    closed = torch.stack(_closed_form(T, (delta * delta, 2.0 * delta * alpha,
                                          2.0 * delta * beta, alpha * alpha, 2.0 * alpha * beta,
                                          beta * beta)))
    G = 16 if K <= 16 else 32
    leaves = _mixed_leaves(mu, sg, u2e, o2e, rou, K, dta, G)
    lane, coop = _pairwise(leaves, 0, G), _xor_tree(leaves)
    # the warps: 32 consecutive sites of one (d, c, l) plane, as the grid lays them out
    S = rou.shape[-1] * rou.shape[-2]
    flat = (cls == MIXED).reshape(-1, S).to(torch.int64)
    warps = torch.nn.functional.pad(flat, (0, -S % 32)).reshape(flat.shape[0], -1, 32)
    n_mixed = warps.sum(-1, keepdim=True).expand(warps.shape).reshape(flat.shape[0], -1)[:, :S]
    cooperative = (n_mixed <= coop_lanes).reshape(rou.shape)
    mixed = torch.where(cooperative, coop, lane)
    sums = torch.where(cls == MIXED, mixed, torch.where(cls == INSIDE, closed, 0.0))
    if forms is not None:
        forms.update(lane=lane, coop=coop, cooperative=cooperative, classes=cls)
    return _write(sums.unbind(0), s, tt, -1.0 / (2.0 * gama))


_NP = {torch.float32: np.float32, torch.float64: np.float64}

VERSIONS = {"plain": (quad_gq.quad_node_gq_torch, quad_gq.truncquad_edge_gq_torch),
            "kernel transcribed": (k10_transcribed, k11_transcribed),
            "v2 transcribed": (k10_v2_transcribed, k11_v2_transcribed)}


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
    # k10_work: 5 site fields, the (M, N, 2) prior and 6 sums, the closed
    # form's operations a site (any K); k11_work: K3's bytes (mu, sigma, rho,
    # 6 sums), with no classes every element mixed (the K^2 points summed by
    # rows: 25 points, 5 rows and nodes, 4 of the tree's six adds), with
    # classes the closed form inside, nothing outside; two roots a site or an
    # element not outside
    F = roofline.FLOPS
    w10 = roofline.k10_work((2, 3, 4), 9)
    assert w10["bytes"] == (5 * 24 + 2 * 12 + 6 * 24) * 4 and w10["roots"] == 48
    assert w10["flops"] == 24 * F["K10 site"] and w10 == roofline.k10_work((2, 3, 4), 2)
    w11 = roofline.k11_work((2, 2, 1, 3, 4), 5, itemsize=8)
    assert w11["bytes"] == 8 * 48 * 8 and w11["roots"] == 96
    mixed = 25 * F["K11 point"] + 5 * (F["K11 row"] + F["K11 node"]) + 4 * 6 + F["K11 site"]
    assert mixed == 25 * 14 + 5 * 11 + 24 + 20
    assert w11["flops"] == 48 * mixed
    assert w11 == {**roofline.k3_work((2, 2, 1, 3, 4), 5, itemsize=8),
                   "flops": w11["flops"], "roots": 96}
    assert roofline.k11_work((2, 2, 1, 3, 4), 5, itemsize=8, classes=(0, 0, 48)) == w11
    w = roofline.k11_work((2, 2, 1, 3, 4), 5, classes=(40, 5, 3))
    assert w["roots"] == 86 and w["bytes"] == 48 * 8 * 4
    assert w["flops"] == 40 * F["K11 closed form"] + 3 * mixed
    with pytest.raises(ValueError, match="add up"):
        roofline.k11_work((2, 2, 1, 3, 4), 5, classes=(40, 5, 2))
    # legacy_v1's lattice: K10's closed form is bound by its bytes (8.84 MB),
    # and so is K11 with every element inside
    rates = roofline.datasheet_rates()
    assert roofline.bound(roofline.k10_work((1, 376, 452), 9), rates)["bound_by"] == "bytes"
    n = 4 * 376 * 452
    assert roofline.bound(roofline.k11_work((2, 2, 1, 376, 452), 9, classes=(n, 0, 0)),
                          rates)["bound_by"] == "bytes"


@pytest.mark.parametrize("K", [2, 3, 5, 9, 12])
def test_closed_form_table_reproduces_the_rule(K):
    # g = c . (1, x1, x2, x1^2, x1 x2, x2^2) at u = 0, o = 1/sqrt2, p = 0 (so
    # x1 = XI, x2 = XJ and Z1, Z2 are Zc, Zr): JAX's gq_accumulate of -g over
    # the K^2 rule is -T c, at 1e-12 of each site's |Ei| in float64
    r = np.random.default_rng(K)
    c = r.uniform(-3, 3, (6, 5, 7))
    shape = c.shape[1:]
    zero, o = jnp.zeros(shape), jnp.full(shape, 1 / math.sqrt(2.0))

    def f(x1, x2):
        return -(c[0] + c[1] * x1 + c[2] * x2 + c[3] * x1 * x1 + c[4] * x1 * x2 + c[5] * x2 * x2)

    want = jax_gq_accumulate(f, zero, zero, o, o, zero, jax_build_table(K, 0, np.float64))
    T = quad_gq.closed_form_table(K)
    assert T.shape == (6, 6) and T.dtype == np.float64
    got = -np.einsum("ij,j...->i...", T, c)
    ei = np.abs(np.asarray(want.Ei))
    for i, name in enumerate(GQRaw._fields):
        np.testing.assert_allclose(got[i], np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-12 * ei.max(), err_msg=name)
    np.testing.assert_array_equal(quad_gq.closed_form_table(K, np.float32), T.astype(np.float32))


@pytest.mark.parametrize("version", ["plain", "v2 transcribed"])
@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("K", [2, 5])
def test_quad_node_sums_match_jax_at_other_rules(K, probe, version):
    # K10 v2 has one instance for every K: K = 2 and 5 beside legacy_v1's 9
    r = np.random.default_rng(K + 40)
    site = _sites(probe, (2, 12, 14), r)
    prior = r.uniform(-10, 2, (12, 14, 2))
    want = jax_gq_accumulate(jax_quadratic(jnp.asarray(prior), 0.05),
                             *(jnp.asarray(a) for a in site), jax_build_table(K, 0, np.float64))
    got = VERSIONS[version][0](t(prior), *map(t, site), K, 0.05)
    _close(got, want, f"K10 {version} K={K} {probe}")


def _margin_inputs(K, dta, dtype, side_out, seed=0, L=1, M=12, N=21):
    """Edge elements whose extreme sample lies at the cutoff to within a
    few dozen of K11 v2's margins: delta = +-(dta - side_out R) plus up to
    40 margins either way, R the reach (|alpha| + |beta|) max|x| (capped
    at 9). With side_out = 1 the nearest samples sit at the cutoff, with -1
    the farthest."""
    r = np.random.default_rng(seed)
    edge = (2, 2, L, M, N)
    mu, sg = r.uniform(-5, 5, (2, L, M, N)), r.uniform(0.01, 2, (2, L, M, N))
    o2, p = r.uniform(0.01, 2, edge), r.uniform(-0.99, 0.99, edge)
    args = [torch.as_tensor(a) for a in (mu, sg, mu[None] + np.zeros(edge), o2, p)]
    _, _, _, reach, margin, _, _ = _reach(*args, K)
    reach = reach.clamp(max=9.0)
    side = torch.as_tensor(np.where(r.uniform(size=edge) < 0.5, -1.0, 1.0))
    jitter = torch.as_tensor(r.uniform(-40, 40, edge))
    eps = torch.finfo(dtype).eps / torch.finfo(torch.float64).eps
    args[2] = args[0][None] + side * (dta - side_out * reach + jitter * margin * eps)
    return [a.to(dtype) for a in args]


def _plain_d(mu, sg, u2e, o2e, rou, K):
    """Every sample's d = x2 - x1 as the port's plain version forms it
    (``ops/gq._whitened_steps``): (K^2,) + the edge shape."""
    from gqmap_tpu_torch.ops.gq import _whitened_steps
    from gqmap_tpu_torch.ops.quadrature import table_on

    tab = table_on(K, 0, False, rou.dtype, rou.device)
    return torch.cat([x2 - x1 for _, _, _, x1, x2 in _whitened_steps(
        mu[None], u2e, sg[None], o2e, rou, tab)])


@pytest.mark.parametrize("probe", ["init", "warm", "clamp", "cutoff", "margin in",
                                   "margin out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k11_v2_classifier_is_conservative(dtype, probe):
    # no element classified inside has a sample of the plain version's d
    # beyond dta, none classified outside one within it; on the margin
    # probes (the cutoff within a few dozen margins of the extreme sample)
    # both classes and the mixed one occur; a NaN in any input makes its
    # element mixed
    K, dta = 9, 10.0
    if probe.startswith("margin"):
        args = _margin_inputs(K, dta, dtype, 1.0 if probe == "margin in" else -1.0, seed=3)
    else:
        args = [t(a).to(dtype) for a in _edge_inputs(probe, K, dta, L=1, M=12, N=21, seed=3)]
    cls = k11_v2_classes(*args, K, dta)
    beyond = _plain_d(*args, K).abs() > dta
    assert not bool(beyond[:, cls == INSIDE].any())
    assert bool(beyond[:, cls == OUTSIDE].all())
    if probe.startswith("margin"):
        counts = [int((cls == c).sum()) for c in (INSIDE, OUTSIDE, MIXED)]
        assert counts[0 if probe == "margin in" else 1] > 20 and counts[2] > 20, counts
    for i, at in enumerate(((0, 0, 3, 5), (1, 0, 7, 0), (1, 1, 0, 11, 20), (0, 1, 0, 2, 2),
                            (1, 0, 0, 4, 9))):
        bad = [a.clone() for a in args]
        bad[i][at] = float("nan")
        got = k11_v2_classes(*bad, K, dta)
        # a NaN in mu or sg reaches both directions' elements at its site
        where = (slice(None),) + at if i < 2 else at
        assert bool((got[where] == MIXED).all())


@pytest.mark.parametrize("probe", PROBES + ("cutoff", "margin in"))
def test_k11_v2_mixed_forms_give_the_same_bits(probe):
    # the per-lane form's pairwise tree and the cooperative form's xor tree
    # over the same leaves are the same sums bit for bit (the tree's adds
    # commute), so no element's sums depend on its warp's choice: routed
    # through every warp's per-lane form, every warp's cooperative form, or
    # the default split, the transcription gives the same bits
    K, dta = 9, 10.0
    args = (_margin_inputs(K, dta, torch.float64, 1.0, seed=4) if probe == "margin in" else
            [t(a) for a in _edge_inputs(probe, K, dta, L=1, M=12, N=21, seed=4)])
    forms = {}
    base = k11_v2_transcribed(*args, K, 1.0, dta, forms=forms)
    mixed = forms["classes"] == MIXED
    assert torch.equal(forms["lane"][:, mixed], forms["coop"][:, mixed])
    for coop_lanes in (0, 32):
        got = k11_v2_transcribed(*args, K, 1.0, dta, coop_lanes=coop_lanes)
        assert all(torch.equal(a, b) for a, b in zip(got, base))


@pytest.mark.parametrize("quad_var", [1.0, 0.05])
def test_legacy_v1_sweep_through_the_v2_transcriptions_matches_jax(quad_var, monkeypatch):
    # legacy_v1's sweep with K10 v2 and K11 v2 (their transcriptions) routed
    # in, against JAX's sweep
    calls = []

    def route(fn):
        def run(*args, quad_chunk=0):
            calls.append(fn.__name__)
            return fn(*args)
        return run

    monkeypatch.setitem(pg._NODE_QUAD, "auto", route(k10_v2_transcribed))
    monkeypatch.setitem(pg._EDGE_ROUTES["K11"], "auto", route(k11_v2_transcribed))
    jc, pc, jp, pp = _problems(dict(dtype="float64", its=2, eval_every=2, quad_var=quad_var))
    js = jg.init_state(jc, gqmap_tpu.FlowRange(*FR), (24, 28))
    j1, jaux = jax.jit(jg.make_sweep(jc, (24, 28)))(jp, js)
    p1, paux = pg.make_sweep(pc, (24, 28))(pp, port_state(js))
    assert calls == ["k10_v2_transcribed", "k11_v2_transcribed"]
    for f in FIELDS:
        assert_close(getattr(p1, f), np.asarray(getattr(j1, f)), 1e-10, 1e-12, f)
    for f in paux._fields:
        assert_close(getattr(paux, f), np.asarray(getattr(jaux, f)), 1e-10, 1e-12, f)


def test_variants_and_their_rules():
    # v2 is the default; K11 v2 holds at most V2_MAX_K nodes by value, so
    # None falls back to v1 beyond them and an explicit "v2" raises; K10 v2
    # takes every K. node_values' nodes are rule_values' (the plain table's
    # XI, XJ), its weights the Gauss-Hermite weights and their products
    assert quad_gq.VARIANTS == ("v1", "v2") and quad_gq._DEFAULT_VARIANT == "v2"
    assert quad_gq.resolve_variant(None, 9, "K11") == "v2"
    assert quad_gq.resolve_variant(None, 33, "K11") == "v1"
    assert quad_gq.resolve_variant(None, 33, "K10") == "v2"
    assert quad_gq.resolve_variant("v1", 9, "K11") == "v1"
    with pytest.raises(ValueError, match="at most 32"):
        quad_gq.resolve_variant("v2", 33, "K11")
    with pytest.raises(ValueError, match="unknown"):
        quad_gq.resolve_variant("v3", 9)
    assert 0 <= quad_gq.COOP_LANES <= 32
    assert len(quad_gq.CLASS_COUNTS) == 6
    for K in (2, 9, 17):
        for dtype in (np.float32, np.float64):
            v = quad_gq.node_values(K, dtype)
            assert v.dtype == dtype and v.shape == (5 * K,)
            np.testing.assert_array_equal(v[:K], quad_gq.rule_values(K, dtype)[:K])
            x, w = (np.asarray(a, np.float64) for a in gauss_hermite(K))
            want = np.concatenate([x, w, w * x, w * x * x, w * (x * x - 1)]).astype(dtype)
            np.testing.assert_array_equal(v, want)
    # unit_rule, a rule of unit weights and no monomials in each variant's
    # form: T's first row sums each coefficient monomial over the points,
    # the rest zero; v2's nodes the rule's with unit weights, v1's point
    # weights 1 and monomials 0
    unit = quad_gq.unit_rule(3)
    assert sorted(unit) == ["closed_form_table", "node_values", "rule_values"]
    x = gauss_hermite(3)[0]
    xi, xj = np.tile(x, 3), np.repeat(x, 3)
    T = unit["closed_form_table"](3)
    np.testing.assert_allclose(T[0], [9, xi.sum(), xj.sum(), (xi * xi).sum(), (xi * xj).sum(),
                                      (xj * xj).sum()], rtol=0, atol=1e-14)
    assert not T[1:].any() and unit["closed_form_table"](3, np.float32).dtype == np.float32
    np.testing.assert_array_equal(unit["node_values"](3), np.concatenate([x, np.ones(3),
                                                                          np.zeros(9)]))
    np.testing.assert_array_equal(unit["rule_values"](3), np.concatenate([
        quad_gq.rule_values(3)[:3], np.ones(9), np.zeros(27)]))
