"""The segment runner's device loop (``make_segment_runner``) on the CPU.

On a CUDA device the runner replays a captured graph of one predicated
sweep and reads the device's sweep count and stop flag once every
``POLL`` sweeps (``route == "graph"``). Here, with no card, the same loop
runs with the eager predicated sweep where each replay would go
(``SegmentRunner(..., _route="predicated")``), and is held to:

* the host loop (``_route="host"``, the plain version: one flag read a
  sweep), bit for bit in float64: state, sweep count, the three traces
  (zero past the sweeps done), the stop flag;
* the JAX package's on-device ``make_segment_runner`` at 1e-10 (relative,
  plus 1e-10 absolute for the state): the flagship cases at
  ``corr_tor=0.99`` (ROADMAP Queue 3, P1: at the flagship clamp two f64
  summation orders separate ~1.5x a sweep), ``full_mixture`` and red-black
  at ``step0=0.03, corr_tor=0.95`` (P2); measured, the largest error is
  0.81 of that tolerance (``tpu_fast``, 30 sweeps).

Cases: the flagship path with the alpha update and annealing, ``its=4``,
a limit that is not a multiple of ``POLL``, ``limit=1``, and a stop in
the middle of a poll window (``tor`` from a recorded |dmu| trace, tripping
at sweep 7 of 30). Shifted-pair toy (24x28, K=5, cosine degrees 16x8,
L=3), both engines from the JAX problem and initial state.
"""

import math

import numpy as np
import pytest
import torch

from _torch_common import port_problem, port_state, shifted_pair
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops import gq, interp
from gqmap_tpu_torch.ops.quadrature import build_table, build_table_1d, table_on

FIELDS = ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it")
FR = (-2.0, 2.0, -2.0, 2.0)
TOY = dict(K=5, L=3, dtype="float64", its=60, eval_every=30)
PRESETS = {"tpu_fast": dict(cheb_p=16, cheb_q=8), "full_mixture": {}}
P1 = dict(corr_tor=0.99)
P2 = dict(step0=0.03, corr_tor=0.95)
# case -> (preset, config, limit)
CASES = {
    "tpu_fast": ("tpu_fast", P1, 30),
    "alpha_anneal": ("tpu_fast", dict(P1, alpha_start=5, temperature=0.2, anneal_every=10), 30),
    "full_mixture": ("full_mixture", P2, 30),
    "redblack": ("tpu_fast", dict(P2, sweep_order="redblack"), 30),
    "its4": ("tpu_fast", dict(P1, its=4), 30),
    "limit_off_window": ("tpu_fast", dict(P1, eval_every=2 * pg.POLL + 3), 2 * pg.POLL + 3),
    "limit1": ("tpu_fast", P1, 1),
}


def _cfgs(preset, **kw):
    kw = {**TOY, **PRESETS[preset], **kw}
    return (getattr(gqmap_tpu.GQMAPConfig, preset)(**kw),
            getattr(gqmap_tpu_torch.GQMAPConfig, preset)(**kw))


@pytest.fixture(scope="module")
def toy():
    I1, I2, _ = shifted_pair()
    fr = gqmap_tpu.FlowRange(*FR)
    out = dict(I1=I1)
    for preset in PRESETS:
        jc, _ = _cfgs(preset)
        jp = jg.make_problem(jc, I1, I2, fr)
        pp = (port_problem(jp) if jp.cheb is not None else problem_from_numpy(dict(
            I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
            interior=np.asarray(jp.interior), rng=tuple(jp.rng), cheb=None), device="cpu"))
        out[preset] = dict(jp=jp, pp=pp, js=jg.init_state(jc, fr, I1.shape))
    return out


def _assert_identical(a, b):
    """Two segment results equal bit for bit."""
    for f in FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    assert a[1] == b[1] and a[5] == b[5]
    for i in (2, 3, 4):
        assert torch.equal(a[i], b[i]), i


def _assert_near_jax(res, jres, n):
    assert res[1] == int(jres[1]) == n and res[5] == bool(jres[5])
    for f in FIELDS:
        np.testing.assert_allclose(getattr(res[0], f).numpy(), np.asarray(getattr(jres[0], f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    for i in (2, 3, 4):
        np.testing.assert_allclose(res[i][:n].numpy(), np.asarray(jres[i])[:n], rtol=1e-10,
                                   atol=0, err_msg=str(i))


def _routes(pc, shape, pp, state, limit):
    """The host loop's and the device loop's results, and the device runner."""
    dev = pg.SegmentRunner(pc, shape, _route="predicated")
    host = pg.SegmentRunner(pc, shape, _route="host")
    return host(pp, state, limit), dev(pp, state, limit), dev


@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_equals_host_loop_and_jax(toy, case):
    preset, kw, limit = CASES[case]
    jc, pc = _cfgs(preset, **kw)
    t = toy[preset]
    shape = toy["I1"].shape
    h, d, dev = _routes(pc, shape, t["pp"], port_state(t["js"]), limit)
    assert dev.route == "predicated"
    _assert_identical(d, h)
    n = d[1]
    want_n = min(limit, pc.its)  # tor = 1e-4 stays below |dmu| on the toy
    assert n == want_n and d[5] == (n == pc.its)
    assert int(d[0].it) == n + 1
    assert d[2].shape == (max(pc.eval_every, limit),)
    for buf in d[2:5]:
        assert torch.isfinite(buf[:n]).all() and not buf[n:].any()
    assert dev.polls == math.ceil(n / pg.POLL)  # one read a window, the last one included
    _assert_near_jax(d, jg.make_segment_runner(jc, shape)(t["jp"], t["js"], limit), n)


def _stop_point(trace, k):
    """The first ``skip`` from which the |dmu| trace falls below all before it
    at sweep ``k + 1`` (and not before)."""
    for skip in range(len(trace) - k):
        if trace[skip + k] < trace[skip:skip + k].min():
            return skip
    return None


def test_stop_in_the_middle_of_a_window(toy):
    # tor between the |dmu| of sweep 7 and the least of the six before it,
    # from the first state whose trace allows it: the stop takes effect on the
    # device inside the first poll window, the later sweeps of the window
    # change nothing, and one read ends the segment
    k = 6
    assert (k + 1) % pg.POLL
    t = toy["tpu_fast"]
    shape = toy["I1"].shape
    jc0, _ = _cfgs("tpu_fast", **P1, tor=0.0)
    jseg = jg.make_segment_runner(jc0, shape)
    trace = np.asarray(jseg(t["jp"], t["js"], 30)[3])
    skip = _stop_point(trace, k)
    assert skip is not None, trace
    js = jseg(t["jp"], t["js"], skip)[0] if skip else t["js"]
    tor = float((trace[skip + k] + trace[skip:skip + k].min()) / 2)
    jc, pc = _cfgs("tpu_fast", **P1, tor=tor)
    h, d, dev = _routes(pc, shape, t["pp"], port_state(js), 30)
    _assert_identical(d, h)
    assert d[1] == k + 1 and d[5] is True and int(d[0].it) == skip + k + 2
    assert not d[2][k + 1:].any() and dev.polls == math.ceil((k + 1) / pg.POLL)
    _assert_near_jax(d, jg.make_segment_runner(jc, shape)(t["jp"], js, 30), k + 1)


@pytest.mark.parametrize("order", ["jacobi", "redblack"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_predicate_keeps_the_bits_or_freezes(toy, preset, order):
    # active = True computes what the sweep computes without it, bit for bit;
    # active = False gives back the state it was given
    _, pc = _cfgs(preset, **P2, sweep_order=order)
    t = toy[preset]
    sweep = pg.make_sweep(pc, toy["I1"].shape)
    st = port_state(t["js"])
    want, waux = sweep(t["pp"], st)
    got, gaux = sweep(t["pp"], st, torch.tensor(True))
    frozen, _ = sweep(t["pp"], st, torch.tensor(False))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(getattr(frozen, f), getattr(st, f)), f
    for a, b in zip(gaux, waux):
        assert torch.equal(a, b)


def test_device_loop_leaves_the_callers_state(toy):
    _, pc = _cfgs("tpu_fast", **P1)
    t = toy["tpu_fast"]
    st = port_state(t["js"])
    before = [x.clone() for x in st]
    res = pg.SegmentRunner(pc, toy["I1"].shape, _route="predicated")(t["pp"], st, 3)
    assert res[1] == 3
    for f, x, y in zip(FIELDS, st, before):
        assert torch.equal(x, y), f


def test_routes_are_chosen_and_checked(toy):
    _, pc = _cfgs("tpu_fast", **P1)
    t = toy["tpu_fast"]
    shape = toy["I1"].shape
    seg = pg.make_segment_runner(pc, shape)
    assert seg.route is None
    seg(t["pp"], port_state(t["js"]), 2)
    assert seg.route == "host" and seg.polls == 2 and seg.capture_s is None
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.SegmentRunner(pc, shape, _route="graph")(t["pp"], port_state(t["js"]), 2)
    with pytest.raises(ValueError, match="unknown segment route"):
        pg.SegmentRunner(pc, shape, _route="eager")
    with pytest.raises(ValueError, match="mesh"):
        pg.SegmentRunner(pc, shape, mesh=object(), _route="predicated")


def test_hoisted_tables_give_the_old_bits():
    # the quadrature tables and the bicubic tap offsets, once built on every
    # call with torch.as_tensor / torch.tensor, are made once and kept:
    # the same values, bit for bit, in each type, and the same tensor again
    cpu = torch.device("cpu")
    for K, chunk, one_d in ((5, 0, False), (9, 27, False), (13, 0, True), (21, 8, True)):
        tab = (build_table_1d if one_d else build_table)(K, chunk, np.float64)
        for dtype in (torch.float64, torch.float32):
            got = table_on(K, chunk, one_d, dtype, cpu)
            assert torch.equal(got, torch.as_tensor(np.stack(tab), dtype=dtype))
            assert table_on(K, chunk, one_d, dtype, cpu) is got
            if one_d:  # gq_accumulate_diff's flat nodes and weights
                assert torch.equal(got[0].reshape(-1), torch.as_tensor(tab.x.reshape(-1),
                                                                        dtype=dtype))
                assert torch.equal(got[1].reshape(-1), torch.as_tensor(tab.w.reshape(-1),
                                                                        dtype=dtype))
    for N2 in (6, 30, 454):
        got = interp._tap_offsets(N2, torch.device("cpu"))
        want = torch.tensor([dr * N2 + dc for dc in range(4) for dr in range(4)],
                            dtype=torch.long)
        assert torch.equal(got, want) and interp._tap_offsets(N2, torch.device("cpu")) is got
    # and the sums that read them, against the tables built as before
    r = np.random.default_rng(7)
    u1, u2 = (torch.as_tensor(r.uniform(-2, 2, (3, 4, 5))) for _ in range(2))
    o1, o2 = (torch.as_tensor(r.uniform(0.1, 2, (3, 4, 5))) for _ in range(2))
    p = torch.as_tensor(r.uniform(-0.9, 0.9, (3, 4, 5)))
    tab1 = build_table_1d(11, 4, np.float64)

    def gd(d):
        return -torch.sqrt(0.01 + d * d)

    x = torch.as_tensor(tab1.x.reshape(-1)).reshape(-1, 1, 1, 1)
    w = torch.as_tensor(tab1.w.reshape(-1)).reshape(-1, 1, 1, 1)
    o1e, o2e = o1 * math.sqrt(2.0), o2 * math.sqrt(2.0)
    c = torch.clamp(o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e, min=torch.finfo(p.dtype).tiny)
    H0 = (w * gd(u1 - u2 + torch.sqrt(c) * x)).sum(0)
    assert torch.equal(gq.gq_accumulate_diff(gd, u1, u2, o1, o2, p, tab1).Ei,
                       math.sqrt(math.pi) * H0)
    # each sum given the kept tensor gives the host table's bits
    dev1 = table_on(11, 4, True, torch.float64, torch.device("cpu"))
    for a, b in zip(gq.gq_accumulate_diff(gd, u1, u2, o1, o2, p, dev1),
                    gq.gq_accumulate_diff(gd, u1, u2, o1, o2, p, tab1)):
        assert torch.equal(a, b)
    assert torch.equal(gq.gq_ei_diff(gd, u1, u2, o1, o2, p, dev1),
                       gq.gq_ei_diff(gd, u1, u2, o1, o2, p, tab1))
    tab2 = build_table(5, 7, np.float64)
    dev2 = table_on(5, 7, False, torch.float64, torch.device("cpu"))

    def f(x1, x2):
        return -torch.sqrt(0.01 + (x1 - 0.3 * x2) ** 2)

    for a, b in zip(gq.gq_accumulate(f, u1, u2, o1, o2, p, dev2),
                    gq.gq_accumulate(f, u1, u2, o1, o2, p, tab2)):
        assert torch.equal(a, b)
    assert torch.equal(gq.gq_ei(f, u1, u2, o1, o2, p, dev2), gq.gq_ei(f, u1, u2, o1, o2, p, tab2))
