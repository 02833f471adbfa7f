"""Kernels K8 and K9 v2: the sweep's update in tiles, its tail in K8's last CTA, the carry.

K8 v2 (``gqmap_tpu_torch/csrc/sweep_update.cu``, ``site_update_v2_kernel``)
runs only on the card, so its work is transcribed here in torch
(``k8_v2_transcribed``): 2-D tiles of ``sweep_update.TILE`` sites of one
component; each raw edge finalized once, by the site that owns it, its
endpoint-2 terms passed to the site one row down or one column right inside
the tile, and evaluated alone (``finalize_end2``) only for the halo, the
edges one row above and one column left of a tile; one partial a tile (a
halving tree over each warp's row of 32, then over the 8 rows); with a
``Tail`` the last CTA's sums (256 strided running sums from 0 over every
partial, dalpha[l] adding component l's among them, then a halving tree:
every sum in one pass), K9's scalar tail and, with a
``Carry``, the next sweep's step, alpha, K1's phase stack and the raw edges'
neighbour stacks.

The transcription's new state is K8 v1's (``k8_transcribed``) and the plain
glue's bit for bit in float32 and float64 on every path of the v1 tests'
``BITS``, at the |rho| clamp, with NaNs, with the predicate false and at
lattice sizes that are not multiples of the tile; one sweep and a 30-sweep
segment through it are held to JAX at 1e-10; the tail's sums are held to the
plain glue's within their order. The carried device loop is held to the
uncarried one bit for bit over 30 sweeps, across two segments with a state
change between them and through a stop. Where the card rounds differently
from the CPU (``it / step_tau``: a product by the reciprocal; ``e.sum()``:
PyTorch's CUDA reduction order), the kernel follows the card
(``sweep_update.step_as_card``, ``softmax_as_card``), and the carried-loop
tests run the plain glue with those two expressions as well, as the card
runs it (``chip_smoke.py`` holds the kernel's carry to the torch expressions
on the card).
"""

import os
import re

import numpy as np
import pytest
import torch

from _torch_common import assert_fields_close, port_state, shifted_pair
from test_torch_sweep_update import (BITS, CASES, FIELDS, FR, LATTICE, PROBES, _captured,
                                     _cfgs, _finalize, _finalize_end2, _node, _problems,
                                     _same_bits, k8_transcribed)
import jax
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu_torch.kernels import COUNTED, build, sweep_update
from gqmap_tpu_torch.kernels.cosine_gq import phase_stack
from gqmap_tpu_torch.kernels.edge_reduced_gq import neighbour_stacks
from gqmap_tpu_torch.kernels.sweep_update import (TILE, V2_THREADS, Carry, EdgeSums, NodeSums,
                                                  Tail, _strided, card_sum, lattice_views)
from gqmap_tpu_torch.models import gqmap as pg

TH, TW = TILE


# ---- K8 v2 and its tail, transcribed ------------------------------------------------------

def _tile_tree(v):
    """Each tile's sum of ``v`` (L, M, N): a halving tree over each warp's 32
    sites (consecutive in the tile's row-major order; the warp's shuffles),
    then over the tile's warps -> (L, G)."""
    L, M, N = v.shape
    TM, TN = -(-M // TH), -(-N // TW)
    x = torch.zeros((L, TM * TH, TN * TW), dtype=v.dtype)
    x[:, :M, :N] = v
    x = x.reshape(L, TM, TH, TN, TW).permute(0, 1, 3, 2, 4)  # (L, TM, TN, rows, columns)
    x = x.reshape(L, TM, TN, TH * TW // 32, 32)  # (..., warps, lanes)
    for _ in range(2):
        while x.shape[-1] > 1:
            h = x.shape[-1] // 2
            x = x[..., :h] + x[..., h:]
        x = x[..., 0]
    return x.reshape(L, TM * TN)


def _tail_scalar(energy, dalpha, dmu, dsig, st0, step, cfg, n_interior, act, loop):
    """K9's scalar tail (``tail_scalar``): the alpha step, anneal, counter,
    predicate, SweepAux and the device loop's bookkeeping."""
    L = dalpha.shape[0]
    it, w, temp = int(st0.it), st0.w.clone(), st0.temperature.clone()
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
        return (wn, tn, itn), aux
    n, stop, bufs = loop
    st0.w.copy_(wn)
    st0.temperature.copy_(tn)
    st0.it.copy_(itn)
    if act:
        slot = min(int(n), bufs.shape[1] - 1)
        bufs[:, slot] = torch.stack(aux[:3])
        stop |= bool(aux[1] < cfg.tor) or int(itn) > cfg.its
        n += 1
    return (st0.w, st0.temperature, st0.it), aux


def k8_v2_transcribed(node, edge, state, alpha, T, step, interior, cfg, rng, colour=None,
                      active=None, stop=None, variant=None, tail=None, carry=None, out=None,
                      max_ctas=0):
    """Kernel K8 v2 in torch, as ``site_update_cuda(..., variant="v2")``
    returns (and, with a loop or carry, writes)."""
    assert variant == "v2"
    L, M, N = state.muu.shape
    dt = state.muu.dtype
    a = alpha.reshape(L, 1, 1)
    su, sv, pn = state.sigmau, state.sigmav, state.pn
    gn = _node(node, a, su, sv, pn, T * 3.0)
    cn_edge = T * -1.0
    top = torch.as_tensor(np.arange(M) % TH == 0)[:, None]  # the tile's first row, column
    first = torch.as_tensor(np.arange(N) % TW == 0)[None, :]
    if edge.form == "grads":
        da, du1, du2, do1, do2, dp = edge.fields
        ge = dict(da=da, du1=du1, do1=do1, dp=dp, E=a * da)
        up = [torch.roll(x[0], 1, -2) for x in (du2, do2)]
        left = [torch.roll(x[1], 1, -1) for x in (du2, do2)]
    else:
        sg = torch.stack([su, sv])
        o2 = torch.stack([torch.roll(sg, -1, -2), torch.roll(sg, -1, -1)])  # down, right
        ge = _finalize(*edge.fields, a, sg[None], o2, state.rou, cn_edge)  # each edge once
        h2 = _finalize_end2(*edge.fields[1:5], a, o2, state.rou, cn_edge)  # the halo's alone
        up = [torch.where(top, torch.roll(h[0], 1, -2), torch.roll(x[0], 1, -2))
              for x, h in zip((ge["du2"], ge["do2"]), h2)]
        left = [torch.where(first, torch.roll(h[1], 1, -1), torch.roll(x[1], 1, -1))
                for x, h in zip((ge["du2"], ge["do2"]), h2)]
    d1u, d1o = ge["du1"], ge["do1"]
    dmuu = gn["du1"] + d1u[0, 0] + d1u[1, 0] + up[0][0] + left[0][0]
    dmuv = gn["du2"] + d1u[0, 1] + d1u[1, 1] + up[0][1] + left[0][1]
    dsu = gn["do1"] + d1o[0, 0] + d1o[1, 0] + up[1][0] + left[1][0]
    dsv = gn["do2"] + d1o[0, 1] + d1o[1, 1] + up[1][1] + left[1][1]

    live = (active is None or bool(active)) and (stop is None or not bool(stop))
    mask = interior & live
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
    E, da_e = ge["E"], ge["da"]
    energy = torch.where(interior, gn["E"] + E[0, 0] + E[0, 1] + E[1, 0] + E[1, 1], zero)
    dalpha = torch.where(interior, gn["da"] + da_e[0, 0] + da_e[0, 1] + da_e[1, 0] + da_e[1, 1],
                         zero)
    part = torch.stack([_tile_tree(x) for x in
                        (energy, dalpha, torch.where(mask, dmuu.abs(), zero),
                         torch.where(mask, dsu.abs(), zero))], -1)
    new = lattice_views(planes)
    if carry is not None:
        if carry.stack is not None:
            carry.stack.copy_(phase_stack(node.cos, *new[:5]))
        if carry.u2e is not None:
            u2e, o2e = neighbour_stacks(torch.stack(new[:2]), torch.stack(new[2:4]))
            carry.u2e.copy_(u2e)
            carry.o2e.copy_(o2e)
    if out is not None:
        assert edge.form == "grads"
        out.copy_(planes)
        planes = out
    if tail is None:
        return planes, part
    G = part.shape[1]
    energy, dalpha, dmu, dsig = sweep_update.v2_tail_sums(part, tail.prev)
    outs, aux = _tail_scalar(energy, dalpha, dmu, dsig, tail.state, step, cfg,
                             tail.n_interior, live, tail.loop)
    if carry is not None:
        carry.step.copy_(sweep_update.step_as_card(outs[2], cfg, dt))
        if carry.alpha is not None:
            carry.alpha.copy_(sweep_update.softmax_as_card(outs[0]))
    assert G == sweep_update.tile_blocks(M, N)
    return planes, part, (*outs, aux)


def _no_k9(*a, **k):
    raise AssertionError("K9 v1 ran on the v2 route")


@pytest.fixture
def v2(monkeypatch):
    """make_sweep's K8 route on the CPU through the v2 transcription; the
    calls made."""
    calls = []

    def run(*a, **k):
        calls.append(("tail" in k, k.get("carry") is not None, k.get("out") is not None))
        return k8_v2_transcribed(*a, **k)

    monkeypatch.setattr(pg, "_update_route", lambda cfg, dist, device: "K8")
    monkeypatch.setitem(pg._UPDATE, "K8", (run, _no_k9))
    monkeypatch.setitem(pg.UPDATE_VARIANT, "K8", "v2")
    return calls


@pytest.fixture
def as_card(monkeypatch):
    """The plain glue's step and softmax as the card rounds them."""
    monkeypatch.setattr(pg, "step_of", sweep_update.step_as_card)
    monkeypatch.setattr(pg, "softmax", sweep_update.softmax_as_card)


# ---- the state: v1's and the plain glue's, bit for bit ---------------------------------------

SHAPES = {"tile multiple": None, "off the tile": (21, 37)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(BITS))
def test_v2_state_is_v1_and_the_plain_glue_bit_for_bit(name, dtype, probe, shape, monkeypatch):
    # K8 v2's new state from the same node and edge outputs, alpha, step and
    # T: K8 v1's and the plain glue's bit for bit; its sums within their
    # order; at the |rho| clamp, with NaNs, with the predicate false, on a
    # lattice the tile divides and on one it does not (21 x 37 sites)
    preset, base, kw, _ = BITS[name]
    size = SHAPES[shape] or base
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype=dtype, **kw)
    I1, I2, _ = shifted_pair(*size)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    if cfg.data_term == "quadratic":
        problem = problem._replace(init_flow=torch.ones(size + (2,), dtype=torch.float64))
    st = pg.init_state(cfg, fr, size, device="cpu")
    r = np.random.default_rng(5)
    if probe == "clamp":
        sign = torch.as_tensor(np.sign(r.uniform(-1, 1, st.rou.shape)), dtype=st.rou.dtype)
        st = st._replace(rou=sign * (cfg.corr_tor - 1e-6), pn=st.pn + 0.999 * cfg.corr_tor,
                         sigmau=torch.full_like(st.sigmau, 0.05))
    elif probe == "nan":
        for f, (l, m, n) in zip(("muu", "sigmav", "pn"), ((0, 8, 4), (1, 7, 31), (2, 16, 0))):
            x = getattr(st, f).clone()
            x[l % cfg.L, m % size[0], n % size[1]] = float("nan")
            st = st._replace(**{f: x})
    node, edge, state, alpha, T, step, interior, c, rng, kw8 = _captured(cfg, size, st,
                                                                        problem, monkeypatch)
    active = torch.tensor(probe != "inactive")
    colour = kw8["colour"]
    planes, part = k8_v2_transcribed(node, edge, state, alpha, T, step, interior, c, rng,
                                     colour=colour, active=active, variant="v2")
    p1, _ = k8_transcribed(node, edge, state, alpha, T, step, interior, c, rng, colour=colour,
                           active=active)
    mask = interior & active
    if colour is not None:
        mask = mask & torch.as_tensor((np.add.outer(np.arange(size[0]), np.arange(size[1]))
                                       & 1) == colour)
    new, sums = sweep_update.site_update_torch(node, edge, state, alpha, T, step, interior,
                                               mask, c, rng)
    for f, x, y in zip(LATTICE, lattice_views(planes), lattice_views(p1)):
        assert _same_bits(x, y), f
        assert _same_bits(x, getattr(new, f)), f
        if probe == "inactive":
            assert _same_bits(x, getattr(state, f)), f
    assert part.shape == (cfg.L, sweep_update.tile_blocks(*size), 4)
    tol = 1e-12 if dtype == "float64" else 1e-5
    got = (part[..., 0].sum(), part[..., 1].sum(-1), part[..., 2].sum(), part[..., 3].sum())
    for g, w in zip(got, sums):
        assert _same_bits(torch.isfinite(g), torch.isfinite(w))
        if bool(torch.isfinite(w).all()):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=0)
    if probe == "nan":
        assert bool(torch.isnan(lattice_views(planes)[0]).any())


def test_each_raw_edge_is_finalized_once_and_the_halo_alone():
    # finalize's endpoint-2 terms are finalize_end2's operation for operation,
    # so the tile's own edges (finalized once) and the halo's (end-2 alone)
    # give the same bits; a tile of 32 x 8 evaluates 32 + 8 edges a channel
    # alone where v1 evaluates all 256
    g = torch.Generator().manual_seed(3)
    x = [torch.rand((2, 2, 3, 9, 40), generator=g, dtype=torch.float64) - 0.5 for _ in range(6)]
    a = torch.rand((3, 1, 1), generator=g, dtype=torch.float64)
    o1, o2 = (torch.rand((2, 2, 3, 9, 40), generator=g, dtype=torch.float64) + 0.1
              for _ in range(2))
    p = torch.rand((2, 2, 3, 9, 40), generator=g, dtype=torch.float64) * 1.8 - 0.9
    for dt in (torch.float64, torch.float32):
        full = _finalize(*(y.to(dt) for y in x), a.to(dt), o1.to(dt), o2.to(dt), p.to(dt),
                         torch.tensor(-0.3, dtype=dt))
        du2, do2 = _finalize_end2(*(y.to(dt) for y in x[1:5]), a.to(dt), o2.to(dt), p.to(dt),
                                  torch.tensor(-0.3, dtype=dt))
        assert torch.equal(full["du2"], du2) and torch.equal(full["do2"], do2)
    assert TILE == (8, 32) and V2_THREADS == TH * TW
    assert sweep_update.tile_blocks(376, 452) == 47 * 15
    assert sweep_update.tile_blocks(94, 113) * 3 >= 132  # the super lattice fills the card
    assert sweep_update.tile_blocks(21, 37) == 3 * 2 and sweep_update.tile_blocks(1, 1) == 1


# ---- against JAX, through make_sweep ----------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_v2_sweep_through_the_transcription_matches_jax(name, v2):
    preset, shape, kw, _ = CASES[name]
    jc, pc = _cfgs(preset, **kw)
    jp, pp, js = _problems(jc, pc, shape)
    j1, jaux = jax.jit(jg.make_sweep(jc, shape))(jp, js)
    p1, paux = pg.make_sweep(pc, shape)(pp, port_state(js))
    passes = 2 if pc.sweep_order == "redblack" else 1
    # one K8 launch a pass, the last with the tail; no carry outside the loop
    assert v2 == [(False, False, False)] * (passes - 1) + [(True, False, False)]
    assert_fields_close(p1, j1, 1e-10, 1e-12, FIELDS)
    assert_fields_close(paux, jaux, 1e-10, 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_v2_segment_through_the_transcription_matches_jax(name, v2, as_card):
    # the carried device loop (K8 v2's tail keeping the trace slot, stop flag
    # and count; the carry in place of the torch expressions) against JAX's
    # segment runner at 1e-10
    preset, shape, kw, multi = CASES[name]
    jc, pc = _cfgs(preset, tor=0.0, **kw, **multi)
    jp, pp, js = _problems(jc, pc, shape)
    jst, jn, jeb, jpb, jsb, jstop = jg.make_segment_runner(jc, shape)(jp, js, 30)
    dev = pg.SegmentRunner(pc, shape, _route="predicated")(pp, port_state(js), 30)
    assert dev[1] == int(jn) == 30 and dev[5] is bool(jstop) is False
    assert_fields_close(dev[0], jst, 1e-10, 1e-10, FIELDS)
    for got, want in zip(dev[2:5], (jeb, jpb, jsb)):
        np.testing.assert_allclose(got[:30].numpy(), np.asarray(want)[:30], rtol=1e-10, atol=0)
    assert len(v2) == 30 * (2 if pc.sweep_order == "redblack" else 1)
    assert all(carried for _, carried, _ in v2)


# ---- the fused tail ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 7, 255, 256, 257, 705, 1600])
def test_fused_tail_sums_in_their_fixed_order(G):
    # the last CTA's order (256 threads' strided running sums from 0, then a
    # halving tree) written as the kernel's loops, against _strided bit for
    # bit in both types, and against torch.sum within the order's rounding
    r = np.random.default_rng(G)
    x64 = torch.as_tensor(r.normal(size=(3, G)) * 10.0 ** r.integers(-3, 4, size=(3, G)))
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        x = x64.to(dt)
        flat = x.reshape(-1)
        acc = [torch.zeros((), dtype=dt) for _ in range(V2_THREADS)]
        for j in range(flat.numel()):
            acc[j % V2_THREADS] = acc[j % V2_THREADS] + flat[j]
        h = V2_THREADS // 2
        while h > 0:
            for t in range(h):
                acc[t] = acc[t] + acc[t + h]
            h //= 2
        assert torch.equal(acc[0], _strided(x))
        scale = float(x64.abs().sum())
        assert abs(float(_strided(x)) - float(x64.sum())) <= tol * scale


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["tpu_fast alpha anneal", "tpu_fast projsplx", "redblack",
                                  "full_mixture"])
def test_fused_tail_is_k9_within_the_sums_order(name, dtype, monkeypatch):
    # one sweep past alpha_start through K8 v2's tail against K8 and K9 v1:
    # the state, T and it bit for bit, the sums and w within their order
    preset, shape, kw, _ = CASES[name]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype=dtype, **{**kw, "alpha_start": 0})
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    st = pg.init_state(cfg, fr, shape, device="cpu")._replace(
        it=torch.tensor(3, dtype=torch.int32))
    monkeypatch.setattr(pg, "_update_route", lambda c, d, dev: "K8")
    monkeypatch.setitem(pg._UPDATE, "K8", (k8_v2_transcribed, _no_k9))
    got, gaux = pg.make_sweep(cfg, shape)(problem, st)
    monkeypatch.setitem(pg.UPDATE_VARIANT, "K8", "v1")
    from test_torch_sweep_update import k9_transcribed
    monkeypatch.setitem(pg._UPDATE, "K8", (k8_transcribed, k9_transcribed))
    want, waux = pg.make_sweep(cfg, shape)(problem, st)
    for f in FIELDS:
        if f != "w":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(want.w, st.w)
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got.w.numpy(), want.w.numpy(), rtol=tol, atol=0)
    np.testing.assert_allclose(torch.stack(gaux).numpy(), torch.stack(waux).numpy(), rtol=tol)


# ---- the carry ------------------------------------------------------------------------------

CARRIED = ("tpu_fast alpha anneal", "tpu_fast projsplx", "full_mixture", "redblack",
           "legacy_v3", "blockmatch_v2")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", CARRIED)
def test_carried_loop_is_the_uncarried_loop(name, dtype, v2, as_card):
    # 30 sweeps of the device loop through K8 v2 with the carry (the step,
    # alpha, K1's stack and the neighbour stacks read from the last sweep's
    # K8, the grads form in place) against the same loop without it, bit for
    # bit: two 15-sweep segments with the state changed between them
    # (reset_para's re-widened sigma and zeroed correlations and counter)
    preset, shape, kw, multi = CASES[name]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(
        dtype=dtype, its=100, tor=0.0, **{**kw, **multi, "alpha_start": 4})
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    if cfg.data_term == "quadratic":
        problem = problem._replace(init_flow=torch.ones(shape + (2,), dtype=torch.float64))
    st = pg.init_state(cfg, fr, shape, device="cpu")
    runs = {}
    for carried in (True, False):
        seg = pg.SegmentRunner(cfg, shape, _route="predicated")
        if not carried:
            seg.sweep.carry = lambda *a, **k: None
        s1 = seg(problem, st, 15)
        st2 = s1[0]._replace(sigmau=torch.full_like(s1[0].sigmau, 2.0),
                             sigmav=torch.full_like(s1[0].sigmav, 2.0),
                             pn=torch.zeros_like(s1[0].pn), rou=torch.zeros_like(s1[0].rou),
                             it=torch.ones_like(s1[0].it))
        runs[carried] = (s1, seg(problem, st2, 15))
    for a, b in zip(runs[True], runs[False]):
        assert a[1] == b[1] == 15 and a[5] is b[5] is False
        for f in FIELDS:
            assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
        for i in (2, 3, 4):
            assert torch.equal(a[i], b[i]), i
    grads = cfg.edge_quad == "reduced" and cfg.edge_kind == "charbonnier"
    assert all(c for _, c, _ in v2[:len(v2) // 2]) and any(o for *_, o in v2) == grads


@pytest.mark.parametrize("name", ["tpu_fast alpha anneal", "full_mixture", "redblack"])
def test_the_carry_is_its_torch_expressions_and_stays_through_a_stop(name, v2, as_card):
    # after each sweep the carry is what the plain expressions give on the new
    # state; once the loop's stop flag holds, K8 v2 rewrites it from the
    # unchanged state and it stays as it was; the graph route's rebuild in
    # place (into=) gives a fresh carry's bits
    preset, shape, kw, multi = CASES[name]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(
        dtype="float64", its=6, tor=0.0, **{**kw, **multi, "alpha_start": 2})
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    seg = pg.SegmentRunner(cfg, shape, _route="predicated")
    st, loop = seg._buffers(pg.init_state(cfg, fr, shape, device="cpu"), 12, problem)
    assert len(loop) == 5 and isinstance(loop[4], Carry)
    carry = loop[4]
    for k in range(9):
        pg._predicated_step(seg.sweep, problem, st, loop)
        fresh = seg.sweep.carry(problem, st)
        for x, y in zip(carry, fresh):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), k
    assert bool(loop[1]) and int(loop[0]) == 6  # stopped after it > its
    again = seg.sweep.carry(problem, st, into=Carry(*(None if x is None else torch.zeros_like(x)
                                                      for x in carry)))
    for x, y in zip(again, carry):
        assert x is None or torch.equal(x, y)
    assert v2[-1] == (True, True, cfg.edge_quad == "reduced")


def test_carry_is_built_only_on_the_v2_route(monkeypatch):
    preset, shape, kw, _ = CASES["tpu_fast"]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype="float64", **kw)
    I1, I2, _ = shifted_pair(*shape)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    problem = pg.make_problem(cfg, I1, I2, fr, device="cpu")
    st = pg.init_state(cfg, fr, shape, device="cpu")
    sweep = pg.make_sweep(cfg, shape)
    assert sweep.carry(problem, st) is None  # the CPU's route is the plain glue
    monkeypatch.setattr(pg, "_update_route", lambda c, d, dev: "K8")
    c = sweep.carry(problem, st)
    assert c.stack.shape == (5, cfg.L) + shape and c.u2e is None and c.alpha.shape == (cfg.L,)
    assert torch.equal(c.stack, phase_stack(problem.cheb, st.muu, st.muv, st.sigmau, st.sigmav,
                                            st.pn))
    monkeypatch.setitem(pg.UPDATE_VARIANT, "K8", "v1")
    assert sweep.carry(problem, st) is None
    assert len(pg.SegmentRunner(cfg, shape)._buffers(st, 4, problem)[1]) == 4


# ---- card_sum, the wrappers, the signatures -----------------------------------------------------

def _reduce_model(x):
    """PyTorch's CUDA reduction of a contiguous 1-D tensor of n < 128 values
    (no vectorized input), written as its kernel runs it (``Reduce.cuh``):
    ``block_width`` = n rounded down to a power of two threads; each thread's
    four accumulators over its stride, combined in order; ``block_x_reduce``'s
    shared-memory halving down to a warp, then ``warp_shfl_down`` with offsets
    decreasing to 1 (lanes past the block read their own value)."""
    n = x.shape[0]
    bw = 1 << (n.bit_length() - 1)
    zero = torch.zeros((), dtype=x.dtype)
    vals = []
    for t in range(bw):
        vl, idx = [zero] * 4, t
        while idx + 3 * bw < n:
            for i in range(4):
                vl[i] = vl[i] + x[idx + i * bw]
            idx += 4 * bw
        for i in range(4):
            if idx >= n:
                break
            vl[i] = vl[i] + x[idx]
            idx += bw
        v = vl[0]
        for i in range(1, 4):
            v = v + vl[i]
        vals.append(v)
    dim = bw
    if dim > 32:
        off = dim // 2
        while off >= 32:
            vals = [vals[t] + vals[t + off] if t < off else vals[t] for t in range(dim)]
            off //= 2
        dim = 32
    off = dim // 2
    while off > 0:
        vals = [vals[t] + vals[t + off] if t + off < dim else vals[t] for t in range(dim)]
        off //= 2
    return vals[0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_card_sum_is_the_reduction_model(dtype):
    g = torch.Generator().manual_seed(11)
    for n in range(1, sweep_update.MAX_CARRY_L + 1):
        for trial in range(3):
            x = torch.exp((torch.rand(n, generator=g, dtype=torch.float64) * 12 - 6)
                          * 10.0 ** (trial - 1)).to(dtype)
            assert torch.equal(card_sum(x), _reduce_model(x)), n
    with pytest.raises(ValueError):
        card_sum(torch.ones(sweep_update.MAX_CARRY_L + 1))
    cfg = gqmap_tpu_torch.GQMAPConfig.tpu_fast(dtype="float32")
    it = torch.tensor(37, dtype=torch.int32)
    inv = np.float32(1.0) / np.float32(cfg.step_tau)
    want = np.float32(cfg.step0) * (np.float32(1.0) / (np.float32(37) * inv + np.float32(1.0)))
    assert float(sweep_update.step_as_card(it, cfg, torch.float32)) == float(want)


def test_v2_wrapper_refusals_and_counters():
    preset, shape, kw, _ = CASES["tpu_fast"]
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(dtype="float64", **kw)
    fr = gqmap_tpu_torch.FlowRange(*FR)
    st = pg.init_state(cfg, fr, shape, device="cpu")
    node = NodeSums("raw", tuple(torch.zeros_like(st.muu) for _ in range(6)))
    edge = EdgeSums("grads", tuple(torch.zeros_like(st.rou) for _ in range(6)))
    one = torch.ones((), dtype=torch.float64)
    interior = torch.ones(shape, dtype=torch.bool)
    args = (node, edge, st, torch.ones(cfg.L, dtype=torch.float64), one, one, interior, cfg, fr)
    with pytest.raises(RuntimeError, match="site_update_cuda needs CUDA"):
        sweep_update.site_update_cuda(*args, variant="v2", tail=Tail(st, 10))
    with pytest.raises(ValueError, match="unknown K8 variant"):
        sweep_update.site_update_cuda(*args, variant="v3")
    with pytest.raises(ValueError, match="K8 v1 takes no tail"):
        sweep_update.site_update_cuda(*args, variant="v1", tail=Tail(st, 10))
    assert sweep_update.sweep_tail_v2 in COUNTED and sweep_update.sweep_tail_v2.launches == 0
    assert pg.UPDATE_VARIANT == {"K8": "v2"}


def test_v2_entry_points_have_their_ctypes_signatures():
    # the v2 entry point takes (ptrs, consts, ints, device, stream), and the
    # wrapper's arrays are the sizes the C++ reads
    text = open(os.path.join(build.CSRC, "sweep_update.cu")).read()
    P, I = build._P, build._I
    for entry in ("gqmap_site_update_v2_f32", "gqmap_site_update_v2_f64"):
        assert build._SIGNATURES[entry] == [P, P, P, I, P]
        assert re.search(rf"^GQMAP_SITE_UPDATE_V2\({entry}, (float|double)\)$", text, re.M)
    sizes = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert sizes["kV2Ptrs"] == 43 and sizes["kV2Ints"] == 13 and sizes["kSitePtrs"] == 27
    assert sizes["kConsts"] + sizes["kTailConsts"] + 4 == 29
    src = open(sweep_update.__file__).read()
    assert "ctypes.c_void_p * 43" in src and "ctypes.c_double * 29" in src
    assert "ctypes.c_int * 13" in src
    assert "constexpr int kTW = 32, kTH = kThreads / kTW;" in text and sizes["kThreads"] == 256


@pytest.mark.parametrize("itemsize", [4, 8])
def test_k8_and_k9_v2_work_count_by_hand(itemsize):
    # v2's bytes: v1's planes, one partial a tile, each tile's halo read
    # again (10 end-2 inputs and 2 sigmas a halo site for raw edges, K2's du2
    # and do2 for its gradients) and, on the device loop, the carried stacks
    from gqmap_tpu_torch.kernels import roofline

    L, M, N = 3, 376, 452
    sites, tiles = L * M * N, L * 47 * 15
    halo = tiles * (8 + 32)
    for node, edge, per_halo, carried in (("modes", "grads", 4, 5), ("raw", "raw", 12, 8),
                                          ("chain", "raw", 12, 8), ("modes", "raw", 12, 13)):
        nf = 7 if node == "chain" else 6
        w = roofline.k8_work((L, M, N), node, edge, itemsize, variant="v2")
        want = ((nf + 24 + 18) * sites + halo * per_halo + 4 * tiles) * itemsize + M * N
        assert w["bytes"] == want, (node, edge)
        wc = roofline.k8_work((L, M, N), node, edge, itemsize, variant="v2", carry=True)
        assert wc["bytes"] == want + carried * sites * itemsize
        assert w["flops"] == roofline.k8_work((L, M, N), node, edge, itemsize)["flops"]
    assert roofline.k9_work(L, M, N, 1, itemsize, variant="v2")["bytes"] == tiles * 4 * itemsize
    assert roofline.k9_work(L, M, N, 2, itemsize, variant="v2")["bytes"] == 2 * tiles * 4 * itemsize
    # the super lattice: 12 x 4 tiles a component
    assert roofline.k9_work(3, 94, 113, 1, 4, variant="v2")["bytes"] == 3 * 48 * 16
