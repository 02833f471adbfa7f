"""Kernels K8 and K9's module: the sweep's update around the node and edge kernels.

The CUDA kernels (``gqmap_tpu_torch/csrc/sweep_update.cu``) run only on the
card, so their work is transcribed here in torch (``k8_transcribed``,
``k9_transcribed``): K8's per-site operations in the kernel's order (each
node form's finalize, the raw edges' finalize at the site and at the up and
left neighbours' edges, the assembly dn + d1[0] + d1[1] + up + left, the
NaN-keeping clamp over interior & predicate & colour), each of its CTAs of
256 sites summing the energy, dalpha, |dmuu| and |dsigmau| by a halving tree,
and K9's fixed order (512 strided running sums, then a halving tree), the
alpha step, anneal, counter, predicate and the device loop's trace slot,
stop flag and count.

These are K8 and K9 v1 (``pg.UPDATE_VARIANT["K8"] = "v1"`` here; v2, the
default, is ``tests/test_torch_update_v2.py``). Routed into ``make_sweep``
(``pg._update_route`` and ``pg._UPDATE``, as
``tests/test_torch_nearest_gq.py`` routes ``k6_transcribed``), one sweep and
a 30-sweep segment of every path K8 takes are held to JAX's ``make_sweep`` /
``make_segment_runner`` in float64 at 1e-10, at the multi-sweep settings of
ROADMAP P1-P3 (``corr_tor = 0.99`` on the flagship paths, ``step0 = 0.03,
corr_tor = 0.95`` where the order is chaotic on the toy). The
transcription's state is the plain glue's (``site_update_torch``,
``sweep_tail_torch``) bit for bit in float32 and float64, at the |rho| clamp,
with NaN inputs and with the predicate false; its sums agree to their
order. On the CPU ``torch.sqrt`` is not correctly rounded (about 0.6% of
values are one ulp off) and the card's is: both the transcription and the
plain glue take the CPU's here, as the kernel and the plain glue take the
card's there.
"""

import glob
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from _torch_common import assert_fields_close, np_fields, port_state, shifted_pair
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import COUNTED, build, sweep_update
from gqmap_tpu_torch.kernels.sweep_update import (CTA_SITES, TAIL_THREADS, EdgeSums, NodeSums,
                                                  lattice_views, stack2)
from gqmap_tpu_torch.models import gqmap as pg

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
LATTICE = ("muu", "muv", "sigmau", "sigmav", "pn", "rou")
FR = (-2.0, 2.0, -2.0, 2.0)
SQRT2 = math.sqrt(2.0)
CONST1 = 1.0 + math.log(2.0 * math.pi)
INV_PI = 1.0 / math.pi
P1 = dict(corr_tor=0.99)
P2 = dict(step0=0.03, corr_tor=0.95)
COS = dict(cheb_p=16, cheb_q=8)
# name: (preset, shape, config, multi-sweep overrides): every path K8 takes
CASES = {
    "tpu_fast": ("tpu_fast", (24, 28), dict(K=5, **COS), P1),
    "tpu_fast alpha anneal": ("tpu_fast", (24, 28), dict(
        K=5, alpha_start=5, temperature=0.2, anneal_every=10, **COS), P1),
    "tpu_fast projsplx": ("tpu_fast", (24, 28), dict(
        K=5, alpha_update="projsplx", alpha_start=5, **COS), P1),
    "full_mixture": ("full_mixture", (24, 28), dict(K=5), P2),
    "super_entropy": ("super_entropy", (32, 40), dict(K=5, **COS), P1),
    "redblack": ("tpu_fast", (24, 28), dict(K=5, sweep_order="redblack", **COS), P2),
    "legacy_v1": ("legacy_v1", (24, 28), dict(K=5), P1),
    "legacy_v2": ("legacy_v2", (24, 28), dict(K=5), P2),
    "legacy_v3": ("legacy_v3", (24, 28), dict(K=5), P2),
    "blockmatch_v2": ("blockmatch_v2", (12, 14), {}, P2),
    "tpu_fast window": ("tpu_fast", (24, 28), dict(
        K=5, window_rg=2, cheb_p=8, cheb_q=4, cheb_ablock=4), P1),
    "chebyshev": ("full_mixture", (24, 28), dict(
        K=5, L=2, data_term="chebyshev", cheb_p=12, cheb_q=8), P2),
}


# ---- the kernels, transcribed -------------------------------------------------------------

def _closed(Ef, dEdu1, dEdu2, dEdo1, dEdo2, dEdp, a, o1, o2, p, cn):
    """csrc closed(): ops/gq.py finalize_closed, operation for operation."""
    pr = 1.0 - p * p
    da = Ef - cn * (torch.log(torch.sqrt(pr) * o1 * o2) + CONST1)
    return dict(da=da, du1=a * dEdu1, du2=a * dEdu2, do1=a * (dEdo1 - cn / o1),
                do2=a * (dEdo2 - cn / o2), dp=a * (dEdp + cn * p / pr), E=a * da)


def _finalize(Ei, Z1, Z2, Sa, Sm, Sxy, a, o1, o2, p, cn):
    """csrc finalize(): ops/gq.py finalize; ``_SQRT2 / x`` is
    ``x.reciprocal() * _SQRT2``, as PyTorch evaluates it."""
    pr = 1.0 - p * p
    sqrtpr = torch.sqrt(pr)
    du1 = a * (Z1 - p * Z2) * (torch.reciprocal(o1 * pr) * SQRT2) * INV_PI
    du2 = a * (Z2 - p * Z1) * (torch.reciprocal(o2 * pr) * SQRT2) * INV_PI
    da = Ei * INV_PI - cn * (torch.log(sqrtpr * o1 * o2) + CONST1)
    sm_w = Sm / sqrtpr
    return dict(da=da, du1=du1, du2=du2, do1=a * ((Sa + sm_w) * INV_PI - cn) / o1,
                do2=a * ((Sa - sm_w) * INV_PI - cn) / o2,
                dp=a * ((Sxy * 2.0 - p * Sa) * INV_PI + cn * p) / pr, E=a * da)


def _finalize_end2(Z1, Z2, Sa, Sm, a, o2, p, cn):
    """csrc finalize_end2(): an edge's du2 and do2 alone."""
    pr = 1.0 - p * p
    du2 = a * (Z2 - p * Z1) * (torch.reciprocal(o2 * pr) * SQRT2) * INV_PI
    do2 = a * ((Sa - Sm / torch.sqrt(pr)) * INV_PI - cn) / o2
    return du2, do2


def _node(node, a, o1, o2, p, cn):
    """csrc node_grads() for each form."""
    if node.form == "modes":
        E0, A1, A2, Aa, Ab, Ax = node.fields
        ku = math.pi / (node.cos.hi_u - node.cos.lo_u)
        kv = math.pi / (node.cos.hi_v - node.cos.lo_v)
        s1, s2 = o1 * ku, o2 * kv
        return _closed(E0 * 0.5, A1 * (-0.5 * ku), A2 * (0.5 * kv),
                       (s2 * p * Ax - s1 * Aa) * (0.5 * ku), (s1 * p * Ax - s2 * Ab) * (0.5 * kv),
                       s1 * 0.5 * s2 * Ax, a, o1, o2, p, cn)
    if node.form == "raw":
        return _finalize(*node.fields, a, o1, o2, p, cn)
    Ei, A1, A2, Ci, Cj, Di, Dj = node.fields
    q, r = torch.sqrt(p + 1.0), torch.sqrt(1.0 - p)
    s, t = (q + r) * 0.5, (q - r) * 0.5
    iq, ir = torch.reciprocal(q), torch.reciprocal(r)  # 1.0 / q, times 1.0: exact
    ds, dt = (iq - ir) * 0.25, (iq + ir) * 0.25
    dEdo1 = (s * Ci + t * Cj) * SQRT2 * INV_PI
    dEdo2 = (t * Di + s * Dj) * SQRT2 * INV_PI
    dEdp = (o1 * (ds * Ci + dt * Cj) + o2 * (dt * Di + ds * Dj)) * SQRT2 * INV_PI
    return _closed(Ei * INV_PI, A1 * INV_PI, A2 * INV_PI, dEdo1, dEdo2, dEdp, a, o1, o2, p, cn)


def _cta_tree(v, G):
    """Each CTA's 256 sites of a component summed by the kernel's halving tree:
    ``v`` (L, M * N) -> (L, G)."""
    L, S = v.shape
    x = torch.zeros((L, G * CTA_SITES), dtype=v.dtype)
    x[:, :S] = v
    x = x.reshape(L, G, CTA_SITES)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def k8_transcribed(node, edge, state, alpha, T, step, interior, cfg, rng, colour=None,
                   active=None, stop=None):
    """Kernel K8 in torch: the new ``(9, L, M, N)`` state and the ``(L, G, 4)``
    partials, as ``site_update_cuda`` returns them."""
    L, M, N = state.muu.shape
    dt = state.muu.dtype
    a = alpha.reshape(L, 1, 1)
    su, sv, pn = state.sigmau, state.sigmav, state.pn
    gn = _node(node, a, su, sv, pn, T * 3.0)
    sg = torch.stack([su, sv])  # (chan, L, M, N)
    cn_edge = T * -1.0
    if edge.form == "grads":
        da, du1, du2, do1, do2, dp = edge.fields
        ge = dict(da=da, du1=du1, do1=do1, dp=dp, E=a * da)
    else:
        o2 = torch.stack([torch.roll(sg, -1, -2), torch.roll(sg, -1, -1)])  # down, right
        ge = _finalize(*edge.fields, a, sg[None], o2, state.rou, cn_edge)
        du2, do2 = _finalize_end2(*edge.fields[1:5], a, o2, state.rou, cn_edge)
    up = [torch.roll(x[0], 1, -2) for x in (du2, do2)]   # the edges one row up
    left = [torch.roll(x[1], 1, -1) for x in (du2, do2)]  # one column left
    d1u, d1o = ge["du1"], ge["do1"]
    dmuu = gn["du1"] + d1u[0, 0] + d1u[1, 0] + up[0][0] + left[0][0]
    dmuv = gn["du2"] + d1u[0, 1] + d1u[1, 1] + up[0][1] + left[0][1]
    dsu = gn["do1"] + d1o[0, 0] + d1o[1, 0] + up[1][0] + left[1][0]
    dsv = gn["do2"] + d1o[0, 1] + d1o[1, 1] + up[1][1] + left[1][1]

    mask = interior.clone()
    if active is not None:
        mask &= active
    if stop is not None:
        mask &= ~stop
    if colour is not None:
        mask &= torch.as_tensor((np.add.outer(np.arange(M), np.arange(N)) & 1) == colour)

    def upd(x, dx, lo, hi, s=step):
        return torch.where(mask, torch.clamp(x + dx * s, lo, hi), x)

    sstep = step * cfg.sigma_step_scale
    ct = cfg.corr_tor
    planes = torch.stack([upd(state.muu, dmuu, rng.minu, rng.maxu),
                          upd(state.muv, dmuv, rng.minv, rng.maxv),
                          upd(su, dsu, cfg.sigma_min, cfg.sigma_max, sstep),
                          upd(sv, dsv, cfg.sigma_min, cfg.sigma_max, sstep),
                          upd(pn, gn["dp"], -ct, ct),
                          *upd(state.rou, ge["dp"], -ct, ct).reshape(4, L, M, N)])
    zero = torch.zeros((), dtype=dt)
    E, da = ge["E"], ge["da"]
    energy = torch.where(interior, gn["E"] + E[0, 0] + E[0, 1] + E[1, 0] + E[1, 1], zero)
    dalpha = torch.where(interior, gn["da"] + da[0, 0] + da[0, 1] + da[1, 0] + da[1, 1], zero)
    G = sweep_update.partial_blocks(M, N)
    part = torch.stack([_cta_tree(x.reshape(L, M * N), G) for x in
                        (energy, dalpha, torch.where(mask, dmuu.abs(), zero),
                         torch.where(mask, dsu.abs(), zero))], -1)
    return planes, part


def _block_sum(x):
    """K9's block_sum: 512 strided running sums from 0, then the halving tree."""
    n = -(-x.numel() // TAIL_THREADS) * TAIL_THREADS
    pad = torch.zeros(n, dtype=x.dtype)
    pad[:x.numel()] = x.reshape(-1)
    acc = torch.zeros(TAIL_THREADS, dtype=x.dtype)
    for row in pad.reshape(-1, TAIL_THREADS):
        acc = acc + row
    while acc.numel() > 1:
        acc = acc[:acc.numel() // 2] + acc[acc.numel() // 2:]
    return acc[0]


def k9_transcribed(parts, state, step, cfg, n_interior, active=None, loop=None):
    """Kernel K9 in torch, as ``sweep_tail_cuda`` returns (and, with ``loop``,
    writes)."""
    last = parts[-1]
    L = last.shape[0]
    energy = _block_sum(last[..., 0])
    dalpha = torch.stack([_block_sum(last[q, :, 1]) for q in range(L)])
    dmu, dsig = _block_sum(last[..., 2]), _block_sum(last[..., 3])
    if len(parts) == 2:
        dmu, dsig = _block_sum(parts[0][..., 2]) + dmu, _block_sum(parts[0][..., 3]) + dsig
    it, w, temp = int(state.it), state.w.clone(), state.temperature.clone()
    act = (active is None or bool(active)) and (loop is None or not bool(loop[1]))
    wn, tn, itn = w.clone(), temp.clone(), it + 1
    if L > 1 and it > cfg.alpha_start:
        lr = step * cfg.alpha_lr_scale
        if cfg.alpha_update == "softmax_natural":
            e = torch.exp(w)
            s = torch.zeros((), dtype=w.dtype)
            for q in range(L):
                s = s + e[q]
            e = e / s
            dot = torch.zeros((), dtype=w.dtype)
            for q in range(L):
                dot = dot + dalpha[q] * e[q]
            wn = torch.clamp(w + e * (dalpha - dot) * lr, -300.0, 300.0)
        else:
            y = w + dalpha * lr
            srt = torch.sort(y, descending=True).values
            css, pick = torch.zeros((), dtype=w.dtype), None
            for q in range(L):
                css = css + srt[q]
                tmax = (css - 1.0) / (q + 1)
                if pick is None and (q == L - 1 or bool(tmax >= srt[q + 1])):
                    pick = tmax
            wn = torch.clamp(y - pick, min=0.0)
    if cfg.anneal_every > 0 and it % cfg.anneal_every == 0:
        tn = torch.clamp(temp * cfg.drate, min=cfg.t_floor)
    if not act:
        wn, tn, itn = w, temp, it
    itn = torch.tensor(itn, dtype=torch.int32)
    aux = (energy, dmu / float(n_interior), dsig / float(n_interior), dalpha)
    if loop is None:
        return wn, tn, itn, aux
    n, stop, bufs = loop
    state.w.copy_(wn)
    state.temperature.copy_(tn)
    state.it.copy_(itn)
    if act:
        slot = min(int(n), bufs.shape[1] - 1)
        bufs[:, slot] = torch.stack(aux[:3])
        stop |= bool(aux[1] < cfg.tor) or int(itn) > cfg.its
        n += 1
    return state.w, state.temperature, state.it, aux


# ---- set-up ---------------------------------------------------------------------------------

def _cfgs(preset, **kw):
    kw = {"dtype": "float64", "its": 60, "eval_every": 30, **kw}
    return (getattr(gqmap_tpu.GQMAPConfig, preset)(**kw),
            getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw))


def _problems(jc, pc, shape):
    """The JAX problem and the port's holding its arrays (and the port's own
    pads, which only the kernels read)."""
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu.FlowRange(*FR)
    jp = jg.make_problem(jc, I1, I2, fr)
    if jc.data_term == "quadratic":
        flow = np.zeros(shape + (2,))
        flow[..., 0] = 1.25
        jp = jp._replace(init_flow=jax.numpy.asarray(flow))
    own = pg.make_problem(pc, I1, I2, gqmap_tpu_torch.FlowRange(*FR), device="cpu")
    pp = problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab), interior=np.asarray(jp.interior),
        rng=tuple(jp.rng), cheb=None if jp.cheb is None else np_fields(jp.cheb),
        init_flow=None if jp.init_flow is None else np.asarray(jp.init_flow),
        grad_tabs=None if jp.grad_tabs is None else [np.asarray(g) for g in jp.grad_tabs],
        nearest_pads=None if own.nearest_pads is None else [x.numpy() for x in own.nearest_pads]),
        device="cpu", data_term=pc.data_term)
    return jp, pp, jg.init_state(jc, fr, shape)


@pytest.fixture
def transcribed(monkeypatch):
    """make_sweep's K8 route on the CPU, through the transcriptions; the
    calls made, by name."""
    calls = []

    def named(fn):
        def run(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(pg, "_update_route", lambda cfg, dist, device: "K8")
    monkeypatch.setitem(pg._UPDATE, "K8", (named(k8_transcribed), named(k9_transcribed)))
    monkeypatch.setitem(pg.UPDATE_VARIANT, "K8", "v1")
    return calls


# ---- against JAX ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_sweep_through_the_transcriptions_matches_jax(name, transcribed):
    preset, shape, kw, _ = CASES[name]
    jc, pc = _cfgs(preset, **kw)
    jp, pp, js = _problems(jc, pc, shape)
    j1, jaux = jax.jit(jg.make_sweep(jc, shape))(jp, js)
    p1, paux = pg.make_sweep(pc, shape)(pp, port_state(js))
    passes = 2 if pc.sweep_order == "redblack" else 1
    assert transcribed == ["k8_transcribed"] * passes + ["k9_transcribed"]
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_segment_through_the_transcriptions_matches_jax(name, transcribed):
    # the segment runner's device loop (the predicated sweep, K9 keeping the
    # trace slot, stop flag and count) against the host loop bit for bit and
    # JAX's segment runner at 1e-10
    preset, shape, kw, multi = CASES[name]
    jc, pc = _cfgs(preset, tor=0.0, **kw, **multi)
    jp, pp, js = _problems(jc, pc, shape)
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, shape)(jp, js, 30)
    dev = pg.SegmentRunner(pc, shape, _route="predicated")(pp, port_state(js), 30)
    host = pg.SegmentRunner(pc, shape, _route="host")(pp, port_state(js), 30)
    assert dev[1] == host[1] == int(jn) == 30 and dev[5] is host[5] is bool(jstop) is False
    for f in FIELDS:
        assert torch.equal(getattr(dev[0], f), getattr(host[0], f)), f
    for i in (2, 3, 4):
        assert torch.equal(dev[i], host[i]), i
    assert_fields_close(dev[0], jst, 1e-10, 1e-10, FIELDS)
    for got, want in zip(dev[2:5], (jeb, jpb, jsb)):
        np.testing.assert_allclose(got[:30].numpy(), np.asarray(want)[:30], rtol=1e-10, atol=0)
    assert set(transcribed) == {"k8_transcribed", "k9_transcribed"}


# ---- against the plain glue, bit for bit -------------------------------------------------------

def _captured(cfg, shape, st, problem, monkeypatch):
    """The node and edge routes' outputs of one K8 launch (the first pass),
    with the launch's other arguments."""
    got = {}

    def grab(node, edge, state, alpha, T, step, interior, cfg_, rng, **kw):
        got.setdefault("call", (node, edge, state, alpha, T, step, interior, cfg_, rng, kw))
        return k8_transcribed(node, edge, state, alpha, T, step, interior, cfg_, rng, **kw)

    monkeypatch.setattr(pg, "_update_route", lambda c, d, dev: "K8")
    monkeypatch.setitem(pg._UPDATE, "K8", (grab, k9_transcribed))
    monkeypatch.setitem(pg.UPDATE_VARIANT, "K8", "v1")
    pg.make_sweep(cfg, shape)(problem, st)
    monkeypatch.undo()
    return got["call"]


def _same_bits(a, b):
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))


PROBES = ("init", "clamp", "nan", "inactive")
BITS = {"tpu_fast": CASES["tpu_fast"], "full_mixture": CASES["full_mixture"],
        "legacy_v1": CASES["legacy_v1"], "legacy_v3": CASES["legacy_v3"],
        "redblack": CASES["redblack"]}


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(BITS))
def test_transcription_state_is_the_plain_glue_bit_for_bit(name, dtype, probe, monkeypatch):
    # K8's new state from the same node and edge outputs, alpha, step and T:
    # the plain glue's bit for bit; the sums within their order (f64 1e-12,
    # f32 1e-5 relative); at the |rho| clamp (every correlation one step from
    # it), with NaN means, sigmas and correlations at a few sites, and with
    # the predicate false (the state comes back as it was)
    preset, shape, kw, _ = BITS[name]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype=dtype, **kw)
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    if cfg.data_term == "quadratic":
        problem = problem._replace(init_flow=torch.ones(shape + (2,), dtype=torch.float64))
    st = pg.init_state(cfg, fr, shape, device="cpu")
    r = np.random.default_rng(5)
    if probe == "clamp":
        sign = torch.as_tensor(np.sign(r.uniform(-1, 1, st.rou.shape)), dtype=st.rou.dtype)
        st = st._replace(rou=sign * (cfg.corr_tor - 1e-6), pn=st.pn + 0.999 * cfg.corr_tor,
                         sigmau=torch.full_like(st.sigmau, 0.05))
    elif probe == "nan":
        for f, (l, m, n) in zip(("muu", "sigmav", "pn"), ((0, 3, 4), (1, 7, 9), (2, 5, 5))):
            x = getattr(st, f).clone()
            x[l % cfg.L, m, n] = float("nan")
            st = st._replace(**{f: x})
    node, edge, state, alpha, T, step, interior, c, rng, kw8 = _captured(cfg, shape, st,
                                                                        problem, monkeypatch)
    active = torch.tensor(probe != "inactive")
    colour = kw8["colour"]
    mask = interior & active
    if colour is not None:
        mask = mask & torch.as_tensor((np.add.outer(np.arange(shape[0]), np.arange(shape[1]))
                                       & 1) == colour)
    planes, part = k8_transcribed(node, edge, state, alpha, T, step, interior, c, rng,
                                  colour=colour, active=active)
    new, sums = sweep_update.site_update_torch(node, edge, state, alpha, T, step, interior,
                                               mask, c, rng)
    for f, x in zip(LATTICE, lattice_views(planes)):
        assert _same_bits(x, getattr(new, f)), f
        if probe == "inactive":
            assert _same_bits(x, getattr(state, f)), f
    n_int = int(interior.sum()) * cfg.L
    w, T2, it, aux = k9_transcribed([part], state, step, c, n_int, active=active)
    pw, pT, pit, paux = sweep_update.sweep_tail_torch([sums], state, step, c, n_int, active)
    assert _same_bits(T2, pT) and torch.equal(it, pit)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for got, want in zip((*aux, w), (*paux, pw)):
        assert _same_bits(torch.isfinite(got), torch.isfinite(want))
        if bool(torch.isfinite(want).all()):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=0)
    if probe == "nan":
        assert bool(torch.isnan(lattice_views(planes)[0]).any())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_loop_through_the_transcriptions_is_the_plain_loop(dtype, transcribed):
    # the predicated step's bookkeeping in K9 (trace slot, stop rule, count,
    # and w, T, it in place) gives the plain step's: a stop in the middle of
    # a window leaves the later sweeps without effect on both
    preset, shape, kw, multi = CASES["tpu_fast alpha anneal"]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype=dtype, its=8, **kw, **multi)
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    st = pg.init_state(cfg, fr, shape, device="cpu")
    got = pg.SegmentRunner(cfg, shape, _route="predicated")(problem, st, 13)
    pg._update_route, kept = (lambda c, d, dev: "plain"), pg._update_route
    try:
        want = pg.SegmentRunner(cfg, shape, _route="predicated")(problem, st, 13)
    finally:
        pg._update_route = kept
    assert got[1] == want[1] == 8 and got[5] and want[5]
    for f in FIELDS:
        if f != "w":
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got[0].w.numpy(), want[0].w.numpy(), rtol=tol)
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), rtol=tol, atol=0)


@pytest.mark.parametrize("mode", ["softmax_natural", "projsplx"])
def test_many_components_through_the_transcriptions(mode, transcribed):
    # K9 keeps its per-component values in global memory, so it takes any L:
    # twenty components and the alpha step in the first sweep, through the
    # transcriptions against the plain glue in float64: the state bit for bit
    # but w, and w (which the step moved) within its dalpha's summation order
    preset, shape, kw, _ = CASES["legacy_v1"]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(
        dtype="float64", L=20, alpha_start=-1, alpha_update=mode, **kw)
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")._replace(
        init_flow=torch.ones(shape + (2,), dtype=torch.float64))
    st = pg.init_state(cfg, fr, shape, device="cpu")
    got, gaux = pg.make_sweep(cfg, shape)(problem, st)
    assert transcribed == ["k8_transcribed", "k9_transcribed"]
    pg._update_route, kept = (lambda c, d, dev: "plain"), pg._update_route
    try:
        want, waux = pg.make_sweep(cfg, shape)(problem, st)
    finally:
        pg._update_route = kept
    for f in FIELDS:
        if f != "w":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.w.shape == (20,) and not torch.equal(want.w, st.w)
    np.testing.assert_allclose(got.w.numpy(), want.w.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(torch.stack(gaux).numpy(), torch.stack(waux).numpy(), rtol=1e-12)


# ---- the route, the wrappers, the buffers -------------------------------------------------------

PRESETS = ("full_mixture", "single_gaussian", "tpu_fast", "super_entropy", "tpu_fast_super",
           "ctf_level", "legacy_v1", "legacy_v2", "legacy_v3", "blockmatch_v2")


@pytest.mark.parametrize("preset", PRESETS)
def test_update_route(preset):
    C = getattr(gqmap_tpu_torch.GQMAPConfig, preset)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for kw in ({}, dict(sweep_order="redblack"), dict(node_kernel="cuda")):
        if kw.get("node_kernel") == "cuda" and preset == "legacy_v1":
            continue  # the quadratic prior has no node kernel
        assert pg._update_route(C(**kw), None, cuda) == "K8"
        assert pg._update_route(C(**kw), None, "cuda") == "K8"
        assert pg._update_route(C(**kw), None, cpu) == "plain"
    hooks = pg.DistHooks(None, None, None, (4, 4), None)
    assert pg._update_route(C(), hooks, cuda) == "plain"  # a mesh: host collectives
    assert pg._update_route(C(node_kernel="torch"), None, cuda) == "plain"
    assert pg._update_route(C(gradient_estimator="autodiff"), None, cuda) == "plain"
    assert pg._update_route(C(L=20), None, cuda) == "K8"  # K9 takes any L
    assert pg._update_route(C(data_term="chebyshev"), None, cuda) == "K8"
    assert pg._update_route(C(edge_kind="truncquad"), None, cuda) == "K8"


def test_cpu_sweep_launches_nothing_and_the_wrappers_refuse_cpu_tensors():
    preset, shape, kw, _ = CASES["tpu_fast"]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype="float64", **kw)
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    st = pg.init_state(cfg, fr, shape, device="cpu")
    before = [k.launches for k in COUNTED]
    pg.make_sweep(cfg, shape)(problem, st)
    pg.SegmentRunner(cfg, shape, _route="predicated")(problem, st, 3)
    assert [k.launches for k in COUNTED] == before == [0] * len(COUNTED)
    assert sweep_update.site_update_cuda in COUNTED and sweep_update.sweep_tail_cuda in COUNTED
    L = cfg.L
    node = NodeSums("raw", tuple(torch.zeros_like(st.muu) for _ in range(6)))
    edge = EdgeSums("grads", tuple(torch.zeros_like(st.rou) for _ in range(6)))
    one = torch.ones((), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="site_update_cuda needs CUDA"):
        sweep_update.site_update_cuda(node, edge, st, torch.ones(L, dtype=torch.float64), one,
                                      one, problem.interior, cfg, fr)
    with pytest.raises(RuntimeError, match="sweep_tail_cuda needs CUDA"):
        sweep_update.sweep_tail_cuda([torch.zeros((L, 1, 4), dtype=torch.float64)], st, one,
                                     cfg, 10)
    assert [k.launches for k in COUNTED] == before


def test_sweep_update_entry_points_have_their_ctypes_signatures():
    # each C entry point sweep_update.cu's macros make is declared in
    # build._SIGNATURES with its parameters' count and kinds
    kinds = {"void*": build._P, "int": build._I, "double": build._D}
    text = open(os.path.join(build.CSRC, "sweep_update.cu")).read()
    macros = {}
    for m in re.finditer(r'#define (GQMAP_\w+)\(NAME, T\)\s*\\\s*extern "C" int NAME\((.*?)\)',
                         text, re.S):
        params = [re.sub(r"[\\\s]+", " ", x).strip() for x in m.group(2).split(",")]
        macros[m.group(1)] = [kinds[re.sub(r"^const |\s*\w+$", "", x).replace(" ", "")]
                              for x in params]
    entries = re.findall(r"^(GQMAP_\w+)\((gqmap_\w+), \w+\)$", text, re.M)
    assert sorted(e for _, e in entries) == ["gqmap_site_update_f32", "gqmap_site_update_f64",
                                             "gqmap_site_update_v2_f32",
                                             "gqmap_site_update_v2_f64",
                                             "gqmap_sweep_tail_f32", "gqmap_sweep_tail_f64"]
    for macro, entry in entries:
        assert build._SIGNATURES[entry] == macros[macro], entry
    assert os.path.join(build.CSRC, "sweep_update.cu") in glob.glob(
        os.path.join(build.CSRC, "*.cu"))


def test_the_kernel_constants_are_the_plain_glues():
    # K8's constants in Consts' order, folded in double as Python folds them
    from gqmap_tpu_torch.ops.cosine import CosData
    from gqmap_tpu_torch.ops.gq import EDGE, NODE

    cfg = gqmap_tpu_torch.GQMAPConfig.tpu_fast()
    cos = CosData(None, -12.0, 4.0, -4.0, 3.0)
    rng = gqmap_tpu_torch.FlowRange(-10.0, 2.0, -2.0, 2.5)
    c = sweep_update.site_consts(NodeSums("modes", (), cos), cfg, rng)
    ku, kv = math.pi / 16.0, math.pi / 7.0
    assert c == (ku, kv, -0.5 * ku, 0.5 * ku, 0.5 * kv, 1.0 / math.pi, math.sqrt(2.0),
                 1.0 + math.log(2.0 * math.pi), NODE, EDGE, -10.0, 2.0, -2.0, 2.5,
                 cfg.sigma_min, cfg.sigma_max, -cfg.corr_tor, cfg.corr_tor,
                 cfg.sigma_step_scale)
    assert sweep_update.partial_blocks(376, 452) == 664 and sweep_update.partial_blocks(1, 1) == 1


def test_lattice_buffers_and_their_stacks():
    L, M, N = 3, 5, 7
    planes = torch.arange(9 * L * M * N, dtype=torch.float64).reshape(9, L, M, N)
    muu, muv, su, sv, pn, rou = lattice_views(planes)
    assert rou.shape == (2, 2, L, M, N) and torch.equal(rou[1, 0], planes[7])
    mu = stack2(muu, muv)  # a view: the two planes are adjacent
    assert mu.data_ptr() == planes.data_ptr() and torch.equal(mu, planes[:2])
    sg = stack2(su, sv)
    assert sg.data_ptr() == planes[2].data_ptr() and torch.equal(sg, planes[2:4])
    apart = stack2(muu, su)  # not adjacent: a copy, as torch.stack
    assert apart.data_ptr() != planes.data_ptr() and torch.equal(apart, torch.stack([muu, su]))
    # the device loop's state: its lattice fields are the views of the buffer
    # its loop carries last, into which K8's new lattice is copied
    cfg = gqmap_tpu_torch.GQMAPConfig.tpu_fast(L=L)
    state = pg.init_state(cfg, pg.FlowRange(-1.0, 1.0, -1.0, 1.0), (M, N), device="cpu")
    st, loop = pg.SegmentRunner(cfg, (M, N))._buffers(state, 4)
    n, stop, bufs, own = loop
    assert own.shape == (9, L, M, N) and bufs.shape == (3, 4) and int(n) == 0 and not stop
    for f, x in zip(LATTICE, lattice_views(own)):
        y = getattr(st, f)
        assert y.data_ptr() == x.data_ptr() and y.shape == x.shape, f
        assert torch.equal(y, getattr(state, f)) and y.data_ptr() != getattr(state, f).data_ptr()
