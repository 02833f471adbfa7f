"""The port's roofline harness (``gqmap_tpu_torch/kernels/roofline.py``) on
the CPU: the kernels' work counts against the bounds ``PERF.md`` section 6
records (at the data sheet's rates and a 1980 MHz SM clock, to the 4
decimals recorded there), the sweep functions at a small size with given
ceilings, and the refusal to measure ceilings anywhere but on a card.
The ceilings themselves are measured by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card."""

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from gqmap_tpu_torch import FlowRange, GQMAPConfig
from gqmap_tpu_torch.kernels import nearest_gq, roofline
from gqmap_tpu_torch.models.gqmap import make_problem

MAIN, SUPER = (376, 452), (94, 113)
# (kernel, work, bound_ms, bound_by) of PERF.md section 6
BOUNDS = {
    "K1 main": (roofline.k1_work((64, 16) + MAIN, 3), 0.2182, "operations"),
    "K2 main": (roofline.k2_work((2, 2, 3) + MAIN, 21), 0.0195, "bytes"),
    "K3 main": (roofline.k3_work((2, 2, 3) + MAIN, 9), 0.0395, "operations"),
    "K1 super": (roofline.k1_work((96, 16) + SUPER, 3), 0.0205, "operations"),
    "K2 super": (roofline.k2_work((2, 2, 3) + SUPER, 25), 0.0012, "bytes"),
    "K3 super": (roofline.k3_work((2, 2, 3) + SUPER, 11), 0.0037, "operations"),
    "K4 main": (roofline.k4_work((3,) + MAIN, 9), 0.0790, "operations"),
    "K4 super": (roofline.k4_work((3,) + SUPER, 11, patch=4), 0.0252, "operations"),
    "K4 ctf_level": (roofline.k4_work((1,) + MAIN, 11), 0.0393, "operations"),
    "K5 main": (roofline.k5_work(MAIN, 9, 96, 16, 3), 2.1500, "operations"),
    "K5 tpu_fast": (roofline.k5_work(MAIN, 9, 64, 16, 3), 1.4399, "operations"),
    "K5 super": (roofline.k5_work(SUPER, 11, 96, 16, 3), 0.2007, "operations"),
    "K5 main tensor cores": (roofline.k5_work(MAIN, 9, 96, 16, 3, tensor_cores=True), 0.7689,
                             "operations"),
    "K5 tpu_fast tensor cores": (roofline.k5_work(MAIN, 9, 64, 16, 3, tensor_cores=True),
                                 0.5126, "operations"),
    "K5 super tensor cores": (roofline.k5_work(SUPER, 11, 96, 16, 3, tensor_cores=True),
                              0.0718, "operations"),
    "K8 main": (roofline.k8_work((3,) + MAIN, "modes", "grads"), 0.0293, "bytes"),
    "K8 full_mixture": (roofline.k8_work((3,) + MAIN, "raw", "raw"), 0.0293, "bytes"),
    "K8 super": (roofline.k8_work((3,) + SUPER, "raw", "raw"), 0.0018, "bytes"),
    "K8 legacy_v3": (roofline.k8_work((1,) + MAIN, "chain", "raw"), 0.0100, "bytes"),
    "K9 main": (roofline.k9_work(3, *MAIN), 0.0000, "bytes"),
    "K13 full_mixture": (roofline.k13_work((3,) + MAIN, 9), 0.1131, "operations"),
    "K14 full_mixture": (roofline.k14_work((2, 2, 3) + MAIN, 9), 0.0405, "operations"),
    "K15 tpu_fast": (roofline.k15_work((2, 2, 3) + MAIN, 21), 0.0170, "bytes"),
}
CEILINGS = dict(roundtrip_ms=0.03, hbm_stream_GBps=3000.0, vpu_GFLOPs=50000.0,
                gather_Mtaps_s=2e5, exp_Gops=2000.0, rsqrt_Gops=4000.0, l1_GBps=30000.0,
                tc_wgmma_tf32_GFLOPs=300000.0, tc_tf32_GFLOPs=200000.0, card="given")


@pytest.mark.parametrize("name", list(BOUNDS))
def test_work_counts_give_the_recorded_bounds(name):
    work, want, by = BOUNDS[name]
    got = roofline.bound(work, roofline.datasheet_rates(1980.0))
    assert round(got["bound_ms"], 4) == want and got["bound_by"] == by, got


def test_work_counts_scale_with_the_shapes():
    # K1's coefficient reads follow the modes a run evaluates (its counters)
    full = roofline.k1_work((64, 16) + MAIN, 3)
    half = roofline.k1_work((64, 16) + MAIN, 3, modes=full["flops"] // 28 // 2)
    assert half["flops"] * 2 == full["flops"] and half["bytes"] < full["bytes"]
    # bytes double with the itemsize; operations and roots do not move
    for f in (lambda s: roofline.k2_work((2, 2, 3, 8, 9), 21, s),
              lambda s: roofline.k3_work((2, 2, 3, 8, 9), 9, s)):
        a, b = f(4), f(8)
        assert b["bytes"] == 2 * a["bytes"] and (a["flops"], a["roots"]) == (b["flops"], b["roots"])


@pytest.mark.parametrize("patch", [1, 2, 4])
def test_k4_work_counts_the_function(patch):
    # a site's pixels share one displacement: one set of weights a point, the
    # block's (patch + 3)^2 tap window, one root a pixel
    L, M, N, K = 2, 5, 7, 9
    points = L * M * N * K * K
    one, blk = roofline.k4_work((L, M, N), K), roofline.k4_work((L, M, N), K, patch=patch)
    assert one["l1_bytes"] == points * 16 * 4
    assert blk["l1_bytes"] == points * (patch + 3) ** 2 * 4
    assert blk["roots"] == points * patch ** 2 + 2 * L * M * N
    per_point = (blk["flops"] - L * M * N * (roofline.FLOPS["K4 site"] + 2 * K)) // points
    assert per_point == (roofline.FLOPS["K4 point"] + 7 * patch * (2 * patch + 3)
                         + 5 * patch ** 2 - 1)
    if patch > 1:  # shared weights: fewer operations and taps a pixel than patch 1
        assert blk["flops"] < patch ** 2 * one["flops"]
        assert blk["l1_bytes"] < patch ** 2 * one["l1_bytes"]
    # frame 1's pixels and frame 2's padded table are read once
    a, b = roofline.k4_work((L, M, N), K, patch, 4), roofline.k4_work((L, M, N), K, patch, 8)
    assert b["bytes"] == 2 * a["bytes"] and b["l1_bytes"] == 2 * a["l1_bytes"]
    assert a["bytes"] == (11 * L * M * N + M * N * patch ** 2
                          + (M * patch + 2) * (N * patch + 2)) * 4


@pytest.mark.parametrize("rg", [0, 2])
def test_k6_work_counts_by_hand(rg):
    # legacy_v2's lattice at K = 9: per point 20 operations, 2 (2 rg + 1)
    # cells of 4, (2 rg + 1)^2 lookups of 4 and a root each; per site 14
    # operations and 2 roots; the table's bytes are the sectors given
    L, M, N, K, W = 1, 376, 452, 9, 2 * rg + 1
    sites, points = L * M * N, L * M * N * K * K
    work = roofline.k6_work((L, M, N), K, rg, sectors=12345)
    assert work["lookups"] == points * W * W
    assert work["flops"] == points * (20 + 2 * W * 4 + W * W * 4) + sites * 14
    assert work["roots"] == points * W * W + 2 * sites
    assert work["bytes"] == (11 * sites + M * N) * 4 + 12345 * 32
    assert work["lookup_bytes"] == points * W * W * 32
    assert roofline.k6_work((L, M, N), K, rg, 12345, itemsize=8)["bytes"] == (
        (11 * sites + M * N) * 8 + 12345 * 32)
    # at one sector a lookup the bytes bound it: 3.44e8 lookups are 11 GB
    if rg == 2:
        sheet = roofline.datasheet_rates(1980.0)
        assert work["lookup_bytes"] / sheet["bytes"] > 3e-3
        assert roofline.bound(work, sheet)["bound_by"] == "operations"


@pytest.mark.parametrize("rg", [0, 2])
def test_k6_v2_work_counts_by_hand(rg):
    # "v2": the padded frame (378 x 454) read once in place of the table's
    # sectors, and per point the stencil: (2 rg + 1)(2 rg + 4) vertical sums
    # and (2 rg + 1)^2 cells, 4 FMAs (8 operations) each
    L, M, N, K, W = 1, 376, 452, 9, 2 * rg + 1
    sites, points = L * M * N, L * M * N * K * K
    v1 = roofline.k6_work((L, M, N), K, rg, sectors=12345)
    work = roofline.k6_work((L, M, N), K, rg, sectors=12345, variant="v2")
    assert work["bytes"] == (11 * sites + M * N) * 4 + 378 * 454 * 4
    assert work["flops"] == v1["flops"] + points * (W * (W + 3) + W * W) * 8
    assert work["roots"] == v1["roots"] and work["lookups"] == v1["lookups"]
    assert roofline.k6_work((L, M, N), K, rg, 0, 8, "v2", (10, 20))["bytes"] == (
        (11 * sites + M * N) * 8 + 200 * 8)
    # at rg = 2 the stencil's operations bound it, at the data sheet's rates
    if rg == 2:
        assert roofline.bound(work, roofline.datasheet_rates(1980.0))["bound_by"] == "operations"


def test_k7_work_counts_by_hand():
    # legacy_v3's lattice at K = 9: per point 35 operations and a root,
    # three tables read at one index (three sectors a distinct sector)
    L, M, N, K = 1, 376, 452, 9
    sites, points = L * M * N, L * M * N * K * K
    work = roofline.k7_work((L, M, N), K, sectors=1000)
    assert work["lookups"] == points and work["lookup_bytes"] == 3 * points * 32
    assert work["flops"] == points * 35 + sites * 15
    assert work["roots"] == points + 2 * sites
    assert work["bytes"] == (12 * sites + M * N) * 4 + 3 * 1000 * 32
    # "v2": the three pads once, three cells of 5 stencil chains a point
    v2 = roofline.k7_work((L, M, N), K, sectors=1000, variant="v2")
    assert v2["bytes"] == (12 * sites + M * N) * 4 + 3 * 378 * 454 * 4
    assert v2["flops"] == work["flops"] + points * 15 * 8 and v2["roots"] == work["roots"]


def test_measured_rates_set_the_bound():
    work = roofline.k3_work((2, 2, 3) + MAIN, 9)
    got = roofline.bound(work, roofline.measured_rates(CEILINGS))
    terms = dict(bytes=work["bytes"] / 3e12, flops=work["flops"] / 5e13,
                 roots=work["roots"] / 4e12)
    assert got["bound_terms_ms"] == pytest.approx({k: v * 1e3 for k, v in terms.items()})
    assert got["bound_ms"] == pytest.approx(max(terms.values()) * 1e3)
    assert got["bound_by"] == "operations"
    # K4's tap term at the measured L1 load rate
    work = roofline.k4_work((3,) + MAIN, 9)
    got = roofline.bound(work, roofline.measured_rates(CEILINGS))
    assert got["bound_terms_ms"]["l1_bytes"] == pytest.approx(work["l1_bytes"] / 3e13 * 1e3)
    # K5's tensor-core term at the measured TF32 rate, beside its FMA-pipe rest
    work = roofline.k5_work(MAIN, 9, 96, 16, 3, tensor_cores=True)
    got = roofline.bound(work, roofline.measured_rates(CEILINGS))
    assert got["bound_terms_ms"]["tc_flops"] == pytest.approx(work["tc_flops"] / 3e14 * 1e3)
    assert got["bound_terms_ms"]["flops"] == pytest.approx(work["flops"] / 5e13 * 1e3)
    assert got["bound_ms"] == pytest.approx(max(got["bound_terms_ms"]["tc_flops"],
                                                got["bound_terms_ms"]["bytes"]))


def test_measured_rates_take_wgmmas_tf32_rate():
    # the tensor cores' rate of the bounds is wgmma's (the instruction K5 v2
    # issues), not mma.sync's, which measure_ceilings reports beside it
    rates = roofline.measured_rates(CEILINGS)
    assert rates["tc_flops"] == CEILINGS["tc_wgmma_tf32_GFLOPs"] * 1e9
    other = dict(CEILINGS, tc_wgmma_tf32_GFLOPs=450000.0)
    assert roofline.measured_rates(other)["tc_flops"] == 4.5e14
    assert roofline.measured_rates(dict(other, tc_tf32_GFLOPs=1.0))["tc_flops"] == 4.5e14
    del other["tc_wgmma_tf32_GFLOPs"]
    with pytest.raises(KeyError, match="tc_wgmma_tf32_GFLOPs"):
        roofline.measured_rates(other)


def test_k8_and_k9_work_count_by_hand():
    # K8 on tpu_fast's lattice: K1's six sums, K2's six (2, 2) fields, the
    # state read and written, the interior mask and 4 values a CTA; each
    # form's operations a site
    L, M, N = 3, 376, 452
    sites, G = L * M * N, -(-M * N // 256)
    for node, edge, fields in (("modes", "grads", 6), ("raw", "raw", 6), ("chain", "raw", 7)):
        for itemsize in (4, 8):
            work = roofline.k8_work((L, M, N), node, edge, itemsize)
            assert work["bytes"] == ((fields + 24 + 18) * sites + L * G * 4) * itemsize + M * N
            f = roofline.FLOPS
            assert work["flops"] == sites * (f[f"K8 {node}"] + 4 * f[f"K8 {edge} edge"]
                                             + f["K8 site"])
    assert roofline.k9_work(L, M, N, 2)["bytes"] == 2 * L * G * 4 * 4
    cfg = GQMAPConfig.tpu_fast(sweep_order="redblack")
    rates = roofline.datasheet_rates(1980.0)
    one = roofline.bound(roofline.k8_work((L, M, N), "modes", "grads"), rates)["bound_ms"]
    assert roofline.update_bound_ms(cfg, (L, M, N), "modes", "grads", rates) == pytest.approx(
        2 * one + roofline.bound(roofline.k9_work(L, M, N, 2), rates)["bound_ms"])


def test_measure_ceilings_needs_a_card(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.measure_ceilings(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.measure_ceilings()
    # the sweep functions without ceilings measure them: on the CPU they raise too
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.sweep_roofline((24, 28), modes=("cosine",), device="cpu")


def test_sweep_roofline_on_the_cpu():
    out = roofline.sweep_roofline((24, 28), ceilings=CEILINGS, device="cpu", n=1)
    assert out["ceilings"] is CEILINGS
    assert list(out["modes"]) == ["cosine", "chebyshev", "nearest", "bicubic"]
    for mode, m in out["modes"].items():
        assert set(m) == {"ms_per_sweep", "mpix_sweeps_per_s", "governing_bound", "bound_ms",
                          "share_of_bound", "device"}, mode
        assert m["ms_per_sweep"] > 0 and m["bound_ms"] > 0 and m["device"] == "cpu"
        assert m["share_of_bound"] == pytest.approx(m["bound_ms"] / m["ms_per_sweep"])
    assert {m: out["modes"][m]["governing_bound"] for m in out["modes"]} == {
        "cosine": "K1+K2+K8+K9", "chebyshev": "K5+K3+K8+K9", "nearest": "K6+K3+K8+K9",
        "bicubic": "K4+K3+K8+K9"}
    # the nearest path runs kernels K6 (node sums; its default "v2" reads the
    # padded frame, not the sectors the converged state's lookups touch), K3
    # (edge sums) and K8 and K9 (the update: raw node and edge sums) and is
    # bound by the sum of their bounds; so is the bicubic path by K4's, K3's,
    # K8's and K9's, the cosine path by K1's, K2's, K8's and K9's
    rates = roofline.measured_rates(CEILINGS)
    update = roofline.bound(roofline.k8_work((3, 24, 28), "raw", "raw"), rates)["bound_ms"] + (
        roofline.bound(roofline.k9_work(3, 24, 28), rates)["bound_ms"])
    cfg = GQMAPConfig.full_mixture(dtype="float32", quad_chunk=27, data_term="nearest")
    fr = FlowRange(-10.0, 2.0, -2.0, 2.0)
    problem = make_problem(cfg, *roofline._pair((24, 28), 0), fr, "cpu")
    st = roofline._converged(cfg, fr, (24, 28), "cpu")
    sectors = nearest_gq.lookup_sectors(problem.I2_tab, st.muu, st.muv, st.sigmau, st.sigmav,
                                        st.pn, 9, cfg.rfc)[1]
    assert 0 < sectors < 3 * 24 * 28 * 81
    assert out["modes"]["nearest"]["bound_ms"] == pytest.approx(
        roofline.bound(roofline.k6_work((3, 24, 28), 9, 0, sectors, variant="v2"),
                       rates)["bound_ms"]
        + roofline.bound(roofline.k3_work((2, 2, 3, 24, 28), 9), rates)["bound_ms"] + update)
    assert out["modes"]["bicubic"]["bound_ms"] == pytest.approx(
        roofline.bound(roofline.k4_work((3, 24, 28), 9), rates)["bound_ms"]
        + roofline.bound(roofline.k3_work((2, 2, 3, 24, 28), 9), rates)["bound_ms"] + update)
    cos = roofline.bound(roofline.k1_work((64, 16, 24, 28), 3), rates)["bound_ms"] + (
        roofline.bound(roofline.k2_work((2, 2, 3, 24, 28), 21), rates)["bound_ms"])
    assert out["modes"]["cosine"]["bound_ms"] == pytest.approx(
        cos + roofline.bound(roofline.k8_work((3, 24, 28), "modes", "grads"), rates)["bound_ms"]
        + roofline.bound(roofline.k9_work(3, 24, 28), rates)["bound_ms"])
    # and the Chebyshev path, kernels K5 (96 x 16; "v2", the contraction on
    # the tensor cores) and K3
    assert out["modes"]["chebyshev"]["bound_ms"] == pytest.approx(
        roofline.bound(roofline.k5_work((24, 28), 9, 96, 16, 3, tensor_cores=True),
                       rates)["bound_ms"]
        + roofline.bound(roofline.k3_work((2, 2, 3, 24, 28), 9), rates)["bound_ms"] + update)


def test_flagship_roofline_on_the_cpu():
    out = roofline.flagship_roofline((24, 28), ceilings=CEILINGS, device="cpu", seg_len=3)
    k, s = out["cosine_kernel_v1"], out["tpu_fast_sweep"]
    assert set(k) == {"ms", "bound_ms", "governing", "share_of_bound"}
    assert set(k["bound_ms"]) == {"vpu", "exp", "hbm"} and k["governing"] in k["bound_ms"]
    assert set(s) == {"ms", "mpix_sweeps_per_s", "bound_ms", "bound_terms_ms", "share_of_bound"}
    assert s["bound_ms"] == pytest.approx(sum(s["bound_terms_ms"].values()))
    assert np.isfinite([k["ms"], s["ms"]]).all() and out["device"] == "cpu"
