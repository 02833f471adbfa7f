"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device. On
a machine with an H100 (no JAX needed) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float64 at 1e-10 of each output's largest magnitude (the
kernel and its plain version differ only in summation order); float32 at
2e-4 of that magnitude plus 2e-5 relative (``tests/test_kernels.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gqmap_tpu_torch import GQMAPConfig
from gqmap_tpu_torch.config import FlowRange
from gqmap_tpu_torch.kernels import (COUNTED, autodiff_gq, build, cheb_gq, cosine_gq, edge_gq,
                                     edge_reduced_gq, nearest_gq, node_gq, quad_gq, window_gq)
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops.cosine import CosData
from gqmap_tpu_torch.ops.gq import EDGE, gq_accumulate
from gqmap_tpu_torch.ops.potentials import make_edge_pot_truncquad
from gqmap_tpu_torch.ops.quadrature import build_table

pytestmark = pytest.mark.cuda
TOL = {torch.float64: (1e-10, 0.0), torch.float32: (2e-4, 2e-5)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.load_library()  # on a CUDA machine a missing nvcc or a failed build fails
    return torch.device("cuda")


def _close(got, want, dtype, name):
    scaled, rel = TOL[dtype]
    err = (got - want).abs()
    bound = scaled * want.abs().max() + rel * want.abs()
    assert bool((err <= bound).all()), (name, float(err.max()), float(want.abs().max()))


@pytest.mark.parametrize("variant", cosine_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L, A, B, M, N", [(3, 64, 16, 7, 45), (1, 13, 5, 12, 37),
                                           (2, 20, 6, 16, 24), (4, 9, 3, 5, 130),
                                           (3, 61, 16, 9, 37), (3, 96, 16, 94, 113)])
def test_cos_mode_sums_kernel_matches_plain(dev, dtype, L, A, B, M, N, variant):
    # (3, 61, 16, 9, 37): S = 333 sites is not a multiple of the 32-site tile,
    # and A = 61 is odd; (3, 96, 16, 94, 113): tpu_fast_super's degrees and
    # super lattice at 376x452 (10,622 sites, not a multiple of 32)
    g = torch.Generator().manual_seed(A * B + L)
    coeffs = torch.randn((A, B, M, N), generator=g, dtype=torch.float64)
    coeffs /= 1.0 + torch.arange(A, dtype=torch.float64).reshape(A, 1, 1, 1)
    cos = CosData(coeffs.to(dev, dtype), -12.0, 4.0, -4.0, 4.0)

    def u(lo, hi):
        return (lo + (hi - lo) * torch.rand((L, M, N), generator=g, dtype=torch.float64)
                ).to(dev, dtype)

    sites = (u(-10, 2), u(-2, 2), u(0.01, 3), u(0.01, 3), u(-0.99, 0.99))
    got = cosine_gq.cos_mode_sums_cuda(cos, *sites, variant=variant)
    want = cosine_gq.cos_mode_sums_torch(cos, *sites)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, dtype, f"sum {k}")


# The JAX package's own variant inputs (tests/test_cosine_kernel.py:128-157, :62-75):
# (A, B, M, N, L, coefficient seed, site seed, sig_hi, o1 shift, p scale)
_VARIANT_CASES = {
    "tight": (24, 6, 16, 24, 3, 15, 16, 0.08, 0.0, None),
    "wide": (48, 6, 16, 16, 2, 17, 18, 3.0, 2.0, 1.1),
    "sigma2": (64, 4, 16, 16, 2, 13, 14, 3.0, 2.0, None),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(_VARIANT_CASES))
def test_cos_mode_sums_variant_branches(dev, dtype, case):
    # each case is held to the plain full sum, and the kernel's counters show
    # that it took the branch the case exists for
    A, B, M, N, L, cseed, sseed, sig_hi, shift, pscale = _VARIANT_CASES[case]
    r = np.random.default_rng(cseed)
    coeffs = r.normal(size=(A, B, M, N)) / (1.0 + np.arange(A)[:, None, None, None])
    r = np.random.default_rng(sseed)
    u1, u2 = r.uniform(-1.5, 2.5, (L, M, N)), r.uniform(-1.2, 0.7, (L, M, N))
    o1, o2 = r.uniform(0.05, sig_hi, (L, M, N)) + shift, r.uniform(0.05, sig_hi, (L, M, N))
    p = r.uniform(-0.9, 0.9, (L, M, N))
    if pscale is not None:
        p = np.clip(p * pscale, -0.99999, 0.99999)
    cos = CosData(torch.tensor(coeffs, device=dev, dtype=dtype), -2.0, 3.0, -1.5, 1.0)
    sites = [torch.tensor(x, device=dev, dtype=dtype) for x in (u1, u2, o1, o2, p)]
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    got = cosine_gq.cos_mode_sums_cuda(cos, *sites, variant="recur", counters=counters)
    want = cosine_gq.cos_mode_sums_torch(cos, *sites)
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, dtype, f"sum {k}")
    recur, exp, modes = counters.tolist()
    tiles = -(-M * N // 32)  # one warp a 32-site tile
    assert recur + exp == tiles
    if case == "tight":
        assert (recur, exp, modes) == (tiles, 0, A * B * L * M * N)
    elif case == "wide":
        assert exp >= 1
    else:
        assert modes < A * B * L * M * N


def _edge_state(g, L, M, N):
    mu = 3 * torch.randn((2, L, M, N), generator=g, dtype=torch.float64)
    sg = 0.01 + 3 * torch.rand((2, L, M, N), generator=g, dtype=torch.float64)
    return mu, sg


def _clamp_rho(g, L, M, N):
    sign = torch.where(torch.rand((2, 2, L, M, N), generator=g) < 0.5, -1.0, 1.0)
    return 0.99999 * sign.double()


# (rule size, generic): the specialised instances, the generic one at a
# size of its own and at the main path's size; K3 also at blockmatch_v2's
# K = 17 (289 points, generic)
K2_RULES = [(21, False), (25, False), (13, False), (21, True)]
K3_RULES = [(9, False), (11, False), (5, False), (9, True), (17, False)]
# M N not a multiple of the kernels' 256-site blocks, and one that is; K2
# finds a site's row without a division and reads its neighbours with the
# wrap at the last row and column; (3, 94, 113) is the super lattice at
# 376x452 (10,622 sites a plane, N odd)
EDGE_SHAPES = [(3, 17, 23), (2, 9, 45), (1, 8, 64), (3, 94, 113)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L, M, N", EDGE_SHAPES)
@pytest.mark.parametrize("k1, generic", K2_RULES)
def test_edge_reduced_kernel_matches_plain(dev, dtype, L, M, N, k1, generic):
    g = torch.Generator().manual_seed(L * M + N)
    mu, sg = _edge_state(g, L, M, N)
    rou = 0.9 * (2 * torch.rand((2, 2, L, M, N), generator=g, dtype=torch.float64) - 1)
    alpha = torch.tensor([0.5, 0.3, 0.2][:L], dtype=torch.float64)
    T = torch.tensor(0.17, dtype=torch.float64)
    args = [x.to(dev, dtype) for x in (mu, sg, rou, alpha, T)]
    n = edge_reduced_gq.edge_reduced_grads_cuda.launches
    got = edge_reduced_gq.edge_reduced_grads_cuda(*args, k1, 5.0, 1e-6, EDGE, generic=generic)
    want = edge_reduced_gq.edge_reduced_grads_torch(*args, k1, 5.0, 1e-6, EDGE)
    torch.cuda.synchronize()
    assert edge_reduced_gq.edge_reduced_grads_cuda.launches == n + 1
    assert got.E is None  # K2 writes the six gradients; its callers form alpha * da
    for name in want._fields[:6]:
        _close(getattr(got, name), getattr(want, name), dtype, name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("split", [(2, 2), (1, 4), (4, 1)])
def test_edge_reduced_kernel_with_halo(dev, dtype, split):
    # a shard's K2: one launch on the block padded with its halo, cropped,
    # against the padded plain version, and equal bit for bit to the whole
    # lattice's launch on that block (the unchanged kernel, per element)
    L, M, N, k1 = 3, 36, 52, 21
    g = torch.Generator().manual_seed(M * N)
    mu, sg = _edge_state(g, L, M, N)
    rou = 0.9 * (2 * torch.rand((2, 2, L, M, N), generator=g, dtype=torch.float64) - 1)
    alpha = torch.tensor([0.5, 0.3, 0.2], dtype=dtype, device=dev)
    T = torch.tensor(0.17, dtype=dtype, device=dev)
    mu, sg, rou = (x.to(dev, dtype) for x in (mu, sg, rou))
    rest = (alpha, T, k1, 5.0, 1e-6, EDGE)
    whole = edge_reduced_gq.edge_reduced_grads_cuda(mu, sg, rou, *rest)
    px, py = split
    ml, nl = M // px, N // py
    ms = torch.stack([mu, sg])
    for i in range(px):
        for j in range(py):
            blk = np.s_[..., i * ml:(i + 1) * ml, j * nl:(j + 1) * nl]
            r, c = ((i + 1) * ml) % M, ((j + 1) * nl) % N
            halo = (ms[..., r:r + 1, j * nl:(j + 1) * nl], ms[..., i * ml:(i + 1) * ml, c:c + 1])
            args = (mu[blk].contiguous(), sg[blk].contiguous(), rou[blk].contiguous(), *rest)
            n = edge_reduced_gq.edge_reduced_grads_cuda.launches
            got = edge_reduced_gq.edge_reduced_grads_cuda(*args, halo=halo)
            want = edge_reduced_gq.edge_reduced_grads_torch(*args, halo=halo)
            torch.cuda.synchronize()
            assert edge_reduced_gq.edge_reduced_grads_cuda.launches == n + 1
            for name in want._fields[:6]:  # K2's E is None
                _close(getattr(got, name), getattr(want, name), dtype, name)
                assert torch.equal(getattr(got, name), getattr(whole, name)[blk]), name


@pytest.mark.parametrize("K", [5, 9])
def test_sweep_launches_both_kernels(dev, K):
    # K = 9 runs K2's instance for K1 = 21, K = 5 its generic one (K1 = 13);
    # the sweep hands K2 the state stacks only, and K3 (and K5) is never launched
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    I2 = np.roll(I1, 1, axis=1)
    cfg = GQMAPConfig.tpu_fast(K=K, cheb_p=16, cheb_q=8, its=3, eval_every=3)
    k1, k2, k3, k5 = (cosine_gq.cos_mode_sums_cuda, edge_reduced_gq.edge_reduced_grads_cuda,
                      edge_gq.edge_gq_cuda, cheb_gq.cheb_gq_cuda)
    n = (k1.launches, k2.launches, k3.launches, k5.launches)
    res = pg.solve(cfg, I1, I2, flow_range=FlowRange(-2, 2, -2, 2), device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    assert (k1.launches - n[0], k2.launches - n[1], k3.launches - n[2],
            k5.launches - n[3]) == (3, 3, 0, 0)


def test_build_is_cached(dev):
    path, built = build.build_library()
    assert not built and path == build.library_path()


def _ratio_to_golden(got, plain, gold):
    # each f32 version against the f64 golden: kernel error at most twice the
    # plain version's, with 1e-6 of the field's magnitude as the floor (the
    # fields the kernel writes: K2's E is None)
    for name in (f for f in gold._fields if getattr(got, f) is not None):
        ref = getattr(gold, name)
        ek = float((getattr(got, name).double() - ref).abs().max())
        ep = float((getattr(plain, name).double() - ref).abs().max())
        assert ek <= 2.0 * ep + 1e-6 * float(ref.abs().max()), (name, ek, ep)


@pytest.mark.parametrize("k1, generic", K2_RULES)
def test_edge_reduced_kernel_f32_at_rho_clamp(dev, k1, generic):
    # At |rho| = 1 - 1e-5 every f32 evaluation loses ~eps32/(1-rho^2) to
    # cancellation, so the kernel is held to the f64 golden on the same
    # inputs: its error is at most twice the plain f32 version's.
    g = torch.Generator().manual_seed(2)
    L, M, N = 3, 17, 23
    mu, sg = _edge_state(g, L, M, N)
    alpha = torch.tensor([0.5, 0.3, 0.2], dtype=torch.float64)
    T = torch.tensor(0.0, dtype=torch.float64)
    args = [x.to(dev, torch.float32) for x in (mu, sg, _clamp_rho(g, L, M, N), alpha, T)]
    rest = (k1, 5.0, 1e-6, EDGE)
    got = edge_reduced_gq.edge_reduced_grads_cuda(*args, *rest, generic=generic)
    plain = edge_reduced_gq.edge_reduced_grads_torch(*args, *rest)
    gold = edge_reduced_gq.edge_reduced_grads_torch(*(x.double() for x in args), *rest)
    _ratio_to_golden(got, plain, gold)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L, M, N", EDGE_SHAPES)
@pytest.mark.parametrize("K, generic", K3_RULES)
def test_edge_gq_kernel_matches_plain(dev, dtype, L, M, N, K, generic):
    g = torch.Generator().manual_seed(L * M + N)
    mu, sg = _edge_state(g, L, M, N)
    rou = 0.9 * (2 * torch.rand((2, 2, L, M, N), generator=g, dtype=torch.float64) - 1)
    args = [x.to(dev, dtype) for x in (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), rou)]
    n = edge_gq.edge_gq_cuda.launches
    got = edge_gq.edge_gq_cuda(*args, K, 5.0, 1e-6, generic=generic)
    want = edge_gq.edge_gq_torch(*args, K, 5.0, 1e-6)
    torch.cuda.synchronize()
    assert edge_gq.edge_gq_cuda.launches == n + 1
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name), dtype, name)


@pytest.mark.parametrize("K, generic", K3_RULES)
def test_edge_gq_kernel_f32_at_rho_clamp(dev, K, generic):
    # K3's raw sums at the |rho| clamp, held to the f64 golden as K2's are
    g = torch.Generator().manual_seed(3)
    L, M, N = 3, 17, 23
    mu, sg = _edge_state(g, L, M, N)
    args = [x.to(dev, torch.float32)
            for x in (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), _clamp_rho(g, L, M, N))]
    rest = (K, 5.0, 1e-6)
    got = edge_gq.edge_gq_cuda(*args, *rest, generic=generic)
    plain = edge_gq.edge_gq_torch(*args, *rest)
    gold = edge_gq.edge_gq_torch(*(x.double() for x in args), *rest)
    _ratio_to_golden(got, plain, gold)


@pytest.mark.parametrize("K", [5, 9])
def test_full_mixture_sweep_launches_edge_gq(dev, K):
    # K = 9 runs K3's instance for that rule, K = 5 its generic one
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    I2 = np.roll(I1, 1, axis=1)
    cfg = GQMAPConfig.full_mixture(K=K, its=3, eval_every=3, quad_chunk=7)
    n = [k.launches for k in COUNTED]
    res = pg.solve(cfg, I1, I2, flow_range=FlowRange(-2, 2, -2, 2), device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    # K4 computes the bicubic node term once a sweep; K8 v2 the update, K9 v2's
    # tail in its last CTA (no K9 v1 launch)
    assert ([k.launches - m for k, m in zip(COUNTED, n)]
            == [0, 0, 3, 3, 0, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("preset", ["tpu_fast", "full_mixture"])
def test_redblack_sweep_launches_each_kernel_twice(dev, preset):
    # the red-black order runs two half-steps, each with the path's kernels
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    I2 = np.roll(I1, 1, axis=1)
    kw = dict(cheb_p=16, cheb_q=8) if preset == "tpu_fast" else dict(quad_chunk=7)
    cfg = getattr(GQMAPConfig, preset)(its=3, eval_every=3, sweep_order="redblack", **kw)
    n = [k.launches for k in COUNTED]
    res = pg.solve(cfg, I1, I2, flow_range=FlowRange(-2, 2, -2, 2), device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    # K8 once a half-step, K9 v2's tail once a sweep (in the second's K8)
    want = ([6, 6, 0, 0, 0, 0, 0, 6, 0, 3, 0, 0, 0, 0, 0, 0, 0] if preset == "tpu_fast"
            else [0, 0, 6, 6, 0, 0, 0, 6, 0, 3, 0, 0, 0, 0, 0, 0, 0])
    assert [k.launches - m for k, m in zip(COUNTED, n)] == want


@pytest.mark.parametrize("preset", ["tpu_fast_super", "super_entropy"])
def test_super_preset_sweep_launches_its_kernels(dev, preset):
    # tpu_fast_super runs K1 (A = 96) and K2's K1 = 25 instance, super_entropy
    # K3's K = 11 instance, once a sweep, on the quarter-resolution lattice
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (32, 48))
    I2 = np.roll(I1, 1, axis=1)
    cfg = getattr(GQMAPConfig, preset)(its=3, eval_every=3)
    n = [k.launches for k in COUNTED]
    res = pg.solve(cfg, I1, I2, flow_range=FlowRange(-2, 2, -2, 2), device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all() and res.map.shape == (8, 12, 2)
    # super_entropy's patch-summed bicubic node term through K4
    want = ([3, 3, 0, 0, 0, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0] if preset == "tpu_fast_super"
            else [0, 0, 3, 3, 0, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0])
    assert [k.launches - m for k, m in zip(COUNTED, n)] == want


def test_library_for_accepts_this_card(dev):
    # the card the tests run on is a Hopper card: the capability check passes
    assert torch.cuda.get_device_capability(dev) == build.CAPABILITY
    assert build.library_for(dev) is build.load_library()


@pytest.mark.parametrize("probe", ["warm", "clamp"])
@pytest.mark.parametrize("K", [9, 17])
def test_edge_gq_kernel_on_l1_lattice(dev, K, probe):
    # the legacy presets' L = 1 edge lattice: legacy_v2 and legacy_v3 at K = 9
    # (specialised), blockmatch_v2 at K = 17 (generic); f64 and f32 against
    # the plain version, and at the |rho| clamp f32 against the f64 golden
    g = torch.Generator().manual_seed(K)
    L, M, N = 1, 47, 57
    mu, sg = _edge_state(g, L, M, N)
    rou = (0.9 * (2 * torch.rand((2, 2, L, M, N), generator=g, dtype=torch.float64) - 1)
           if probe == "warm" else _clamp_rho(g, L, M, N))
    host = (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), rou)
    rest = (K, 1.7, 1e-4)
    for dtype in (torch.float64, torch.float32):
        args = [x.to(dev, dtype) for x in host]
        got = edge_gq.edge_gq_cuda(*args, *rest)
        plain = edge_gq.edge_gq_torch(*args, *rest)
        if dtype == torch.float32 and probe == "clamp":
            _ratio_to_golden(got, plain, edge_gq.edge_gq_torch(*(x.double() for x in args), *rest))
        else:
            for name in plain._fields:
                _close(getattr(got, name), getattr(plain, name), dtype, name)


@pytest.mark.parametrize("override", [dict(edge_kind="truncquad", edge_quad="reduced"),
                                      dict(gradient_estimator="autodiff", edge_kind="truncquad")])
def test_cuda_edge_route_without_a_kernel_raises(dev, override):
    # no kernel computes reduced truncated-quadratic edges (K11 takes the
    # tensor rule's) or truncated-quadratic edges under autodiff (K14 and K15
    # take Charbonnier edges): edge_kernel="cuda" raises rather than run the
    # plain path
    cfg = GQMAPConfig.legacy_v2(edge_kernel="cuda", **override)
    with pytest.raises(ValueError, match="kernel K2 or K3, .* or kernel K11"):
        pg.make_sweep(cfg, (24, 40))
    # under autodiff K1 computes the cosine term, K13 the bicubic term without
    # a window and K16 with one of radius 1 to 4: a wider window stays plain
    with pytest.raises(ValueError, match="kernel K16, which does not take"):
        pg.make_sweep(GQMAPConfig.full_mixture(node_kernel="cuda", gradient_estimator="autodiff",
                                               window_rg=5), (24, 40))
    # the windowed bicubic term is K12's: "cuda" builds a sweep that launches it
    cfg, problem, state = _graph_toy(dev, "full_mixture", node_kernel="cuda", window_rg=2,
                                     quad_chunk=7)
    n = window_gq.node_window_gq_cuda.launches
    st, _ = pg.make_sweep(cfg, (24, 40))(problem, state)
    torch.cuda.synchronize()
    assert window_gq.node_window_gq_cuda.launches == n + 1 and bool(torch.isfinite(st.muu).all())


@pytest.mark.parametrize("preset, kw, want", [
    ("legacy_v2", {}, (0, 0, 3, 0, 0, 3, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0)),
    ("legacy_v3", {}, (0, 0, 3, 0, 0, 0, 3, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0)),
    ("blockmatch_v2", {}, (0, 0, 3, 0, 0, 3, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0)),
    ("tpu_fast", dict(window_rg=2, cheb_p=16, cheb_q=8),
     (3, 3, 0, 0, 0, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0)),
    ("legacy_v2", dict(gradient_estimator="autodiff"),
     (0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0, 0)),
    ("tpu_fast", dict(gradient_estimator="autodiff", cheb_p=16, cheb_q=8),
     (3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0)),
    ("full_mixture", dict(gradient_estimator="autodiff", quad_chunk=7),
     (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 0)),
])
def test_legacy_preset_solve_launches_its_kernels(dev, preset, kw, want):
    # K3 once a sweep on the legacy presets' Charbonnier tensor edges (L = 1;
    # blockmatch_v2 at K = 17) beside K6 (the nearest lookup, windowed on
    # legacy_v2) or K7 (legacy_v3's Prewitt chain), K1 and K2 on the windowed
    # cosine term; under autodiff K6's value and K14 (legacy_v2), K1 and K15
    # (tpu_fast), K13 and K14 (full_mixture)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    I2 = np.roll(I1, 1, axis=1)
    cfg = getattr(GQMAPConfig, preset)(its=3, eval_every=3, **kw)
    n = [k.launches for k in COUNTED]
    res = pg.solve(cfg, I1, I2, flow_range=FlowRange(-2, 2, -2, 2), device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    # autodiff's update is plain; K4 and K5 are never launched here; K8 v2 and
    # its tail (K9 v2) run the update of every other path
    assert [k.launches - m for k, m in zip(COUNTED, n)] == list(want)


def test_legacy_v1_segment_launches_no_kernel(dev):
    # The segment launches no kernel of K1-K7 (the name predates K8-K11): K10
    # computes the quadratic prior's sums and K11 the truncated-quadratic
    # tensor-rule edges', K8 v2 runs the update, its last CTA K9 v2's tail,
    # each once a sweep
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    cfg = GQMAPConfig.legacy_v1(its=3)
    fr = FlowRange(-2, 2, -2, 2)
    flow = np.zeros((24, 40, 2))
    problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, dev)._replace(
        init_flow=torch.as_tensor(flow, device=dev))
    n = [k.launches for k in COUNTED]
    st, done, eb, *_ = pg.make_segment_runner(cfg, (24, 40))(
        problem, pg.init_state(cfg, fr, (24, 40), device=dev), 3)
    assert done == 3 and bool(torch.isfinite(eb[:3]).all())
    assert ([k.launches - m for k, m in zip(COUNTED, n)]
            == [0, 0, 0, 0, 0, 0, 0, 3, 0, 3, 3, 3, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("probe", ["init", "warm", "clamp"])
@pytest.mark.parametrize("M, N", [(376, 452), (47, 57)])
def test_edge_gq_kernel_on_ctf_lattice(dev, M, N, probe):
    # ctf_level's K = 11 rule (specialised) on the L = 1 edge lattice of the
    # coarse-to-fine pyramid's finest and coarsest levels at 376x452 (47x57:
    # a block hangs past the lattice); f64 and f32 against the plain
    # version, at the |rho| clamp f32 against the f64 golden
    cfg = GQMAPConfig.ctf_level()
    g = torch.Generator().manual_seed(M + N)
    mu, sg = _edge_state(g, 1, M, N)
    if probe == "init":
        rou = torch.zeros((2, 2, 1, M, N), dtype=torch.float64)  # sigma per site, as init_state
    elif probe == "warm":
        rou = 0.9 * (2 * torch.rand((2, 2, 1, M, N), generator=g, dtype=torch.float64) - 1)
    else:
        rou = _clamp_rho(g, 1, M, N)
    host = (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg), rou)
    rest = (cfg.K, cfg.lambdas, cfg.epsn)
    assert cfg.K == 11 and cfg.L == 1 and cfg.K in edge_gq.SPECIALISED
    for dtype in (torch.float64, torch.float32):
        args = [x.to(dev, dtype) for x in host]
        n = edge_gq.edge_gq_cuda.launches
        got = edge_gq.edge_gq_cuda(*args, *rest)
        assert edge_gq.edge_gq_cuda.launches == n + 1
        plain = edge_gq.edge_gq_torch(*args, *rest)
        if dtype == torch.float32 and probe == "clamp":
            _ratio_to_golden(got, plain, edge_gq.edge_gq_torch(*(x.double() for x in args), *rest))
        else:
            for name in plain._fields:
                _close(getattr(got, name), getattr(plain, name), dtype, name)


def test_ctf_pyramid_launches_k3_once_a_sweep(dev):
    # the coarse-to-fine driver on the card: every level's sweeps through K3
    from gqmap_tpu_torch.models.ctf import solve_coarse_to_fine

    r = np.random.default_rng(4)
    I1 = r.uniform(0, 255, (48, 64))
    I2 = np.roll(I1, 1, axis=1)
    gt = np.stack([1.0 + 0.5 * np.cos(np.arange(48) / 8)[:, None] + 0 * I1, 0 * I1], -1)
    n = [k.launches for k in COUNTED]
    res = solve_coarse_to_fine(GQMAPConfig.ctf_level(its=4, eval_every=2), I1, I2, gt,
                               scales=(0.25, 0.5, 1.0), device=dev)
    sweeps = sum(lv.iters for lv in res.levels)
    assert sweeps == 12 and np.isfinite(res.flow).all()
    # K4 (the bicubic node term) and K3 once a sweep of every level, K8 v2 and
    # its tail too
    assert ([k.launches - m for k, m in zip(COUNTED, n)]
            == [0, 0, sweeps, sweeps, 0, 0, 0, sweeps, 0, sweeps, 0, 0, 0, 0, 0, 0, 0])


def test_structure_texture_on_card_matches_cpu(dev):
    from gqmap_tpu_torch.io.preprocess import structure_texture

    img = np.random.default_rng(2).uniform(0, 255, (61, 83))
    got = structure_texture(img, device=dev)
    want = structure_texture(img, device="cpu")
    assert np.abs(got - want).max() <= 1e-10 * (img.max() - img.min())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chebyshev_sweep_through_k3_matches_plain(dev, dtype):
    # one full_mixture sweep with the Chebyshev term: K3 and K5 launched once,
    # the state within the kernels' tolerance of the plain routes'; the series
    # on the card equals its value on the CPU (float64: summation order only)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    I2 = np.roll(I1, 1, axis=1)
    kw = dict(dtype=str(dtype)[6:], data_term="chebyshev", cheb_p=24, cheb_q=8, quad_chunk=7)
    fr = FlowRange(-2, 2, -2, 2)
    cfg = GQMAPConfig.full_mixture(**kw)
    prob = pg.make_problem(cfg, I1, I2, fr, device=dev)
    st = pg.init_state(cfg, fr, I1.shape, device=dev)
    n = edge_gq.edge_gq_cuda.launches, cheb_gq.cheb_gq_cuda.launches
    got, gaux = pg.make_sweep(dataclasses.replace(cfg, node_kernel="cuda", edge_kernel="cuda"),
                              I1.shape)(prob, st)
    want, waux = pg.make_sweep(dataclasses.replace(cfg, node_kernel="torch", edge_kernel="torch"),
                               I1.shape)(prob, st)
    torch.cuda.synchronize()
    assert (edge_gq.edge_gq_cuda.launches - n[0], cheb_gq.cheb_gq_cuda.launches - n[1]) == (1, 1)
    for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
        _close(getattr(got, f), getattr(want, f), dtype, f)
    if dtype == torch.float64:
        cpu = pg.make_problem(cfg, I1, I2, fr, device="cpu")
        x = torch.as_tensor(r.uniform(-3, 3, (2, 3, 24, 40)))
        on_card = pg._node_f(cfg, prob)(x.to(dev), x.flip(0).to(dev)).cpu()
        _close(on_card, pg._node_f(cfg, cpu)(x, x.flip(0)), dtype, "series")


def test_measure_ceilings_on_the_card(dev):
    from gqmap_tpu_torch.kernels import roofline

    ceil = roofline.measure_ceilings(device=dev)
    rates = ("hbm_stream_GBps", "vpu_GFLOPs", "vpu_1chain_GFLOPs", "gather_Mtaps_s",
             "exp_Gops", "rsqrt_Gops", "l1_GBps", "fma_sm_clock_MHz", "fma_1chain_sm_clock_MHz",
             "tc_tf32_GFLOPs")
    assert all(np.isfinite(ceil[k]) and ceil[k] > 0 for k in rates + ("roundtrip_ms",)), ceil
    # no measured rate above the data sheet's; independent chains at least as
    # fast as one dependent chain
    sheet = roofline.datasheet_rates()
    assert ceil["hbm_stream_GBps"] * 1e9 <= sheet["bytes"], ceil
    assert ceil["vpu_1chain_GFLOPs"] <= ceil["vpu_GFLOPs"] * 1.02, ceil
    assert ceil["vpu_GFLOPs"] * 1e9 <= sheet["flops"], ceil
    assert ceil["rsqrt_Gops"] * 1e9 <= sheet["roots"], ceil
    assert ceil["tc_tf32_GFLOPs"] * 1e9 <= sheet["tc_flops"], ceil
    assert ceil["card"] and "W" in ceil["card"]


# the segment runner's graph route against its host loop on the toy
GRAPH_CASES = {
    "tpu_fast f64": ("tpu_fast", dict(dtype="float64"), 30),
    "tpu_fast f32": ("tpu_fast", {}, 30),
    "full_mixture": ("full_mixture", dict(quad_chunk=7, step0=0.03, corr_tor=0.95), 30),
    "super_entropy": ("super_entropy", {}, 30),
    "redblack": ("tpu_fast", dict(sweep_order="redblack", step0=0.03, corr_tor=0.95), 30),
    "full_mixture chebyshev": ("full_mixture", dict(quad_chunk=7, data_term="chebyshev",
                                                    cheb_p=24, cheb_q=8, corr_tor=0.99), 30),
    "legacy_v2": ("legacy_v2", dict(step0=0.03, corr_tor=0.95), 30),
    "legacy_v3": ("legacy_v3", dict(step0=0.03, corr_tor=0.95), 30),
    "blockmatch_v2": ("blockmatch_v2", dict(step0=0.03, corr_tor=0.95), 30),
    "its4": ("tpu_fast", dict(its=4), 30),
    "limit1": ("tpu_fast", {}, 1),
    # the autodiff estimator's kernel paths: the backward captured with the sweep
    "tpu_fast autodiff": ("tpu_fast", dict(gradient_estimator="autodiff", corr_tor=0.99), 30),
    "full_mixture autodiff": ("full_mixture", dict(gradient_estimator="autodiff", quad_chunk=7,
                                                   corr_tor=0.99), 30),
    "legacy_v2 autodiff": ("legacy_v2", dict(gradient_estimator="autodiff", step0=0.03,
                                             corr_tor=0.95), 30),
}


def _graph_toy(dev, preset, **kw):
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    toy = dict(cheb_p=16, cheb_q=8) if preset == "tpu_fast" else {}
    cfg = getattr(GQMAPConfig, preset)(**{"its": 60, "eval_every": 30, **toy, **kw})
    fr = FlowRange(-2, 2, -2, 2)
    problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, dev)
    return cfg, problem, pg.init_state(cfg, fr, (24, 40), device=dev)


def _counted(seg, *args):
    n = [k.launches for k in COUNTED]
    res = seg(*args)
    torch.cuda.synchronize()
    return res, [k.launches - m for k, m in zip(COUNTED, n)]


def _identical(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and a[1] == b[1]
            and a[5] == b[5] and all(torch.equal(a[i], b[i]) for i in (2, 3, 4)))


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_segment_equals_host_loop(dev, case):
    # one predicated sweep captured and replayed: state, sweep count, traces
    # and flag bit for bit the host loop's, one read of (n, stop) a POLL
    # window, each replay counted as a sweep's launches (a stop inside a
    # window leaves the window's later replays without effect, but they
    # launch); a second call replays the same graph
    preset, kw, limit = GRAPH_CASES[case]
    cfg, problem, state = _graph_toy(dev, preset, **kw)
    h, hn = _counted(pg.SegmentRunner(cfg, (24, 40), _route="host"), problem, state, limit)
    seg = pg.make_segment_runner(cfg, (24, 40))
    g, gn = _counted(seg, problem, state, limit)
    captured = seg._captured
    assert seg.route == "graph" and seg.capture_s > 0
    n = h[1]
    replays = min(pg.POLL * seg.polls, limit)
    assert _identical(g, h) and sum(hn) > 0 and gn == [c // n * replays for c in hn]
    assert n == min(limit, cfg.its) and seg.polls == -(-n // pg.POLL)
    assert not g[2][n:].any() and int(g[0].it) == n + 1
    g2, _ = _counted(seg, problem, state, limit)
    assert seg._captured is captured and _identical(g2, h)


def test_graph_segment_stops_where_the_host_loop_does(dev):
    # tor between sweep 7's |dmu| and the least of the six before it, from
    # the first state whose trace allows it: the stop inside a poll window
    # gives the host loop's n, flag, traces and state
    cfg, problem, state = _graph_toy(dev, "tpu_fast", tor=0.0)
    host = pg.SegmentRunner(cfg, (24, 40), _route="host")
    trace = host(problem, state, 40)[3].cpu().numpy()
    k = 6
    skip = next(s for s in range(len(trace) - k) if trace[s + k] < trace[s:s + k].min())
    start = host(problem, state, skip)[0] if skip else state
    tor = float((trace[skip + k] + trace[skip:skip + k].min()) / 2)
    scfg = dataclasses.replace(cfg, tor=tor)
    h = pg.SegmentRunner(scfg, (24, 40), _route="host")(problem, start, 30)
    seg = pg.make_segment_runner(scfg, (24, 40))
    g, gn = _counted(seg, problem, start, 30)
    assert h[1] == k + 1 and h[5] and _identical(g, h)
    assert seg.polls == -(-(k + 1) // pg.POLL)
    # every replay of the window launched the sweep's kernels (K9 v2's tail in K8 v2)
    replays = min(pg.POLL * seg.polls, 30)
    assert gn == [replays, replays, 0, 0, 0, 0, 0, replays, 0, replays, 0, 0, 0, 0, 0, 0, 0]


def test_graph_segment_keeps_its_copy_of_a_host_init_flow(dev):
    # legacy_v1's prior as a float64 numpy array: the graph reads the device
    # copy made at capture, which must live as long as the graph; calls with
    # NaN-filled tensors of the copy's size allocated between them (which
    # would take its block were it freed) stay bit for bit the host loop's
    cfg, problem, state = _graph_toy(dev, "legacy_v1", quad_var=0.05)
    M, N = pg.flow_lattice_shape(cfg, (24, 40))
    prior = np.random.default_rng(3).uniform(-1.0, 1.0, (M, N, 2))
    problem = problem._replace(init_flow=prior)
    h = pg.SegmentRunner(cfg, (24, 40), _route="host")(problem, state, 12)
    seg = pg.make_segment_runner(cfg, (24, 40))
    g = seg(problem, state, 12)
    captured = seg._captured
    junk = []
    for _ in range(3):
        assert seg.route == "graph" and _identical(g, h)
        junk += [torch.full((M, N, 2), float("nan"), dtype=problem.I1.dtype, device=dev)
                 for _ in range(4)]
        g = seg(problem, state, 12)
    assert _identical(g, h) and seg._captured is captured
    assert captured.run.init_flow.device.type == "cuda"


# K4 (the bicubic node quadrature) at the main path's shapes on 376x452:
# full_mixture's lattice at K = 9, super_entropy's lattice of 4x4 blocks at
# K = 11, ctf_level's L = 1 lattice at K = 11; and two ragged lattices (a
# partial last block of threads, patch 1 and 4): (L, K, patch, frame)
K4_CASES = {
    "full_mixture": (3, 9, 1, (376, 452)),
    "super_entropy": (3, 11, 4, (376, 452)),
    "ctf_level": (1, 11, 1, (376, 452)),
    "ragged patch 1": (2, 9, 1, (37, 53)),
    "ragged patch 4": (2, 11, 4, (36, 52)),
}


def _k4_inputs(dev, dtype, L, patch, shape, probe):
    """Frames, VV = pad_cubic(I2) and the five state fields: the init's wide
    sigmas, sigma = 0.05, or the |rho| clamp with sigma per site in [0.01, 3];
    means over the flow range of chip_smoke.py, so queries leave the frame."""
    from gqmap_tpu_torch.ops.interp import pad_cubic

    g = torch.Generator().manual_seed(sum(shape) + L)
    I1 = 255 * torch.rand(shape, generator=g, dtype=torch.float64)
    M, N = shape[0] // patch, shape[1] // patch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((L, M, N), generator=g, dtype=torch.float64)

    pn = torch.zeros((L, M, N), dtype=torch.float64)
    if probe == "init":
        su, sv = u(12, 13), u(4, 5)
    elif probe == "converged":
        su = sv = torch.full((L, M, N), 0.05, dtype=torch.float64)
    else:
        su, sv = u(0.01, 3), u(0.01, 3)
        pn = 0.99999 * torch.where(u(0, 1) < 0.5, -1.0, 1.0)
    st = [x.to(dev, dtype) for x in (u(-10, 2), u(-2, 2), su, sv, pn)]
    return (I1.to(dev, dtype), pad_cubic(I1.roll(1, 1).to(dev, dtype)), *st)


@pytest.mark.parametrize("variant", node_gq.VARIANTS)
@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_node_gq_kernel_matches_plain(dev, case, dtype, probe, variant):
    # float64 within 1e-10 of each sum's largest magnitude; float32 held to
    # the f64 golden on the same inputs (ratio rule)
    L, K, patch, shape = K4_CASES[case]
    args = _k4_inputs(dev, dtype, L, patch, shape, probe)
    n = node_gq.node_gq_cuda.launches
    got = node_gq.node_gq_cuda(*args, K, 1.0, 1e-6, patch=patch, variant=variant)
    torch.cuda.synchronize()
    assert node_gq.node_gq_cuda.launches == n + 1
    plain = node_gq.node_gq_torch(*args, K, 1.0, 1e-6, patch=patch, quad_chunk=27)
    if dtype == torch.float64:
        for name in plain._fields:
            _close(getattr(got, name), getattr(plain, name), dtype, name)
    else:
        gold = node_gq.node_gq_torch(*(x.double() for x in args), K, 1.0, 1e-6, patch=patch,
                                     quad_chunk=27)
        _ratio_to_golden(got, plain, gold)


@pytest.mark.parametrize("variant", node_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["full_mixture", "super_entropy"])
def test_node_gq_kernel_nan_probe(dev, case, dtype, variant):
    # NaN means, sigmas and correlations at a few sites: NaN exactly there in
    # the kernel and its plain version (D3), every other site as the NaN-free
    # call gives it, bit for bit; no read leaves the table (v2: a CTA with a
    # NaN site reads through L1, the others from its window)
    L, K, patch, _ = K4_CASES[case]
    args = list(_k4_inputs(dev, dtype, L, patch, (64, 96), "converged"))
    clean = node_gq.node_gq_cuda(*args, K, 1.0, 1e-6, patch=patch, variant=variant)
    _, M, N = args[2].shape
    sites = [(0, 1, 2), (1, M // 2, N // 3), (2, M - 1, N - 1), (1, 0, N // 2)]
    mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
    for field, site in zip((2, 3, 5, 6), sites):  # muu, muv, sv, pn
        args[field] = args[field].clone()
        args[field][site] = float("nan")
        mask[site] = True
    got = node_gq.node_gq_cuda(*args, K, 1.0, 1e-6, patch=patch, variant=variant)
    plain = node_gq.node_gq_torch(*args, K, 1.0, 1e-6, patch=patch)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, clean):
        assert torch.equal(torch.isnan(g), mask) and torch.equal(torch.isnan(p), mask)
        assert torch.equal(g[~mask], c[~mask])


@pytest.mark.parametrize("variant", node_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["full_mixture", "super_entropy"])
def test_node_gq_kernel_on_a_block_equals_the_whole(dev, case, dtype, variant):
    # frame 1 addressed at a shard's pixel origin: the block's sums are the
    # whole lattice's there, bit for bit (the sharded sweep's K4 call; v2's
    # CTAs tile the block otherwise than the whole, at an odd offset too)
    L, K, patch, _ = K4_CASES[case]
    I1, VV, *st = _k4_inputs(dev, dtype, L, patch, (64, 96), "converged")
    whole = node_gq.node_gq_cuda(I1, VV, *st, K, 1.0, 1e-6, patch=patch, variant=variant)
    _, M, N = st[0].shape
    for r0, c0, m, n in ((0, 0, M // 2, N // 2), (M // 2, N // 3, M - M // 2, N - N // 3),
                         (3, 5, M - 6, N - 7)):
        blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
        got = node_gq.node_gq_cuda(I1, VV, *(x[blk].contiguous() for x in st), K, 1.0, 1e-6,
                                   patch=patch, origin=(r0 * patch, c0 * patch),
                                   local_image_shape=(m * patch, n * patch), variant=variant)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[blk])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["full_mixture", "super_entropy", "ctf_level"])
def test_node_gq_v2_window_route_and_l1_route_agree(dev, case, dtype):
    # v2's sites read the table from their CTA's shared-memory window, or
    # through L1 where a site's own box exceeds the budget: none on the
    # converged probe at the main shapes, every one (and every CTA without a
    # window) on a probe with sigma ~ 40 px and with a budget of 0; the sums
    # are the same bit for bit on every route
    L, K, patch, shape = K4_CASES[case]
    sites = (L, shape[0] // patch, shape[1] // patch)
    ctas, n_sites = node_gq.v2_ctas(sites, patch), L * sites[1] * sites[2]
    for probe, wide in (("converged", False), ("init", True)):
        args = list(_k4_inputs(dev, dtype, L, patch, shape, probe))
        if wide:
            args[4], args[5] = args[4] * 3.0, args[5] * 8.0
        cnt = torch.zeros(2, dtype=torch.int64, device=dev)
        got = node_gq.node_gq_cuda(*args, K, 1.0, 1e-6, patch=patch, l1_counts=cnt)
        every = torch.zeros(2, dtype=torch.int64, device=dev)
        l1 = node_gq.node_gq_cuda(*args, K, 1.0, 1e-6, patch=patch, window_bytes=0,
                                  l1_counts=every)
        torch.cuda.synchronize()
        want = [ctas, n_sites] if wide else [0, 0]
        assert cnt.tolist() == want, (probe, cnt.tolist(), want)
        assert every.tolist() == [ctas, n_sites]
        for g, w in zip(got, l1):
            assert torch.equal(g, w)


def test_full_mixture_graph_segment_launches_k4(dev):
    # the exact path's segment on the graph route: K4 and K3 once a replayed sweep
    cfg, problem, state = _graph_toy(dev, "full_mixture", quad_chunk=7)
    seg = pg.make_segment_runner(cfg, (24, 40))
    _, counts = _counted(seg, problem, state, 20)
    assert seg.route == "graph" and counts == [0, 0, 20, 20, 0, 0, 0, 20, 0, 20, 0, 0, 0, 0, 0,
                                               0, 0]


# K12 (the windowed bicubic node term) at the main paths' shapes on 376x452:
# full_mixture(window_rg=2)'s lattice at K = 9, legacy_v2(data_term="bicubic")'s
# L = 1 lattice, and a ragged lattice at radii 1 and 3 (the generic
# instance): (L, K, rg, frame)
K12_CASES = {
    "full_mixture window_rg=2": (3, 9, 2, (376, 452)),
    "legacy_v2 bicubic": (1, 9, 2, (376, 452)),
    "ragged rg=1": (2, 9, 1, (37, 53)),
    "ragged rg=3": (2, 5, 3, (37, 53)),
}


def _k12_args(dev, dtype, case, probe, shape=None):
    L, K, rg, frame = K12_CASES[case]
    return _k4_inputs(dev, dtype, L, 1, shape or frame, probe), K, rg


def _v1_compiled(dtype, K, rg):
    """Whether K12 v1 runs a compiled instance (float32, K = 9, rg = 2): its
    arrays in registers, as every v2 instance keeps them."""
    return dtype == torch.float32 and K == 9 and rg == 2


@pytest.mark.parametrize("variant", window_gq.VARIANTS)
@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K12_CASES))
def test_window_gq_kernel_matches_plain(dev, case, dtype, probe, variant):
    # float64 within 1e-10 of each sum's largest magnitude; float32 held to
    # the f64 golden on the same inputs (the ratio rule of
    # tests/test_f32_conditioning.py); the generic instance beside
    args, K, rg = _k12_args(dev, dtype, case, probe)
    n = window_gq.node_window_gq_cuda.launches
    got = window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, variant=variant)
    generic = window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, variant=variant,
                                            generic=True)
    torch.cuda.synchronize()
    assert window_gq.node_window_gq_cuda.launches == n + 2
    plain = window_gq.node_window_gq_torch(*args, K, 1.0, 1e-6, rg, quad_chunk=27)
    if dtype == torch.float64:
        for out in (got, generic):
            for name in plain._fields:
                _close(getattr(out, name), getattr(plain, name), dtype, name)
    else:
        gold = window_gq.node_window_gq_torch(*(x.double() for x in args), K, 1.0, 1e-6, rg,
                                              quad_chunk=27)
        _ratio_to_golden(got, plain, gold)
        _ratio_to_golden(generic, plain, gold)


@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K12_CASES))
def test_window_gq_v2_is_v1_bit_for_bit(dev, case, dtype, probe):
    # v2 is v1's arithmetic op for op on v1's lanes: its sums are v1's
    # compiled instance's bit for bit, and its runtime-K instance's are its
    # compiled one's; v1's runtime-rg instance keeps its tap rows in local
    # memory, where the compiler fuses other products, so against it v2 is
    # held to the tolerance of test_window_gq_kernel_matches_plain
    args, K, rg = _k12_args(dev, dtype, case, probe)
    v1, v2, v2g = (window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, variant=v, generic=g)
                   for v, g in (("v1", False), ("v2", False), ("v2", True)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(v2, v2g))
    if _v1_compiled(dtype, K, rg):
        assert all(torch.equal(a, b) for a, b in zip(v2, v1))
    elif dtype == torch.float64:
        for name in v1._fields:
            _close(getattr(v2, name), getattr(v1, name), dtype, name)
    else:
        plain = window_gq.node_window_gq_torch(*args, K, 1.0, 1e-6, rg, quad_chunk=27)
        gold = window_gq.node_window_gq_torch(*(x.double() for x in args), K, 1.0, 1e-6, rg,
                                              quad_chunk=27)
        _ratio_to_golden(v2, plain, gold)
        _ratio_to_golden(v1, plain, gold)


@pytest.mark.parametrize("variant", window_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_gq_kernel_nan_probe(dev, dtype, variant):
    # NaN means, sigmas and correlations at a few sites: NaN exactly there in
    # the kernel and its plain version, every other site as the NaN-free call
    # gives it, bit for bit
    args, K, rg = _k12_args(dev, dtype, "full_mixture window_rg=2", "converged", (64, 96))
    args = list(args)
    clean = window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, variant=variant)
    L, M, N = args[2].shape
    sites = [(0, 1, 2), (1, M // 2, N // 3), (2, M - 1, N - 1), (1, 0, N // 2)]
    mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
    for field, site in zip((2, 3, 5, 6), sites):  # muu, muv, sv, pn
        args[field] = args[field].clone()
        args[field][site] = float("nan")
        mask[site] = True
    got = window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, variant=variant)
    plain = window_gq.node_window_gq_torch(*args, K, 1.0, 1e-6, rg)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, clean):
        assert torch.equal(torch.isnan(g), mask) and torch.equal(torch.isnan(p), mask)
        assert torch.equal(g[~mask], c[~mask])


@pytest.mark.parametrize("variant", window_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["full_mixture window_rg=2", "ragged rg=3"])
def test_window_gq_kernel_routes_and_blocks_are_bit_for_bit(dev, case, dtype, variant):
    # the L1 route (a budget of 0; at full_mixture's 376x452 also sigma ~ 40
    # px, every site's box over the budget) gives the shared-window route's
    # sums bit for bit; a shard's block (frame 1 and VV whole, addressed at
    # its pixel origin; windows across the cut) is the whole lattice's there,
    # bit for bit
    args, K, rg = _k12_args(dev, dtype, case, "converged", (64, 96))
    I1, VV, *st = args
    kw = dict(variant=variant)
    sites = tuple(st[0].shape)
    ctas, n_sites = window_gq.window_ctas(sites), math.prod(sites)
    cnt = torch.zeros(2, dtype=torch.int64, device=dev)
    whole = window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, l1_counts=cnt, **kw)
    every = torch.zeros(2, dtype=torch.int64, device=dev)
    l1 = window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, window_bytes=0,
                                       l1_counts=every, **kw)
    torch.cuda.synchronize()
    assert cnt.tolist() == [0, 0] and every.tolist() == [ctas, n_sites]
    assert all(torch.equal(g, w) for g, w in zip(whole, l1))
    if case == "full_mixture window_rg=2":
        wide = list(_k12_args(dev, dtype, case, "init")[0])
        wide[4], wide[5] = wide[4] * 3.0, wide[5] * 8.0
        big = tuple(wide[2].shape)
        cnt.zero_()
        w1 = window_gq.node_window_gq_cuda(*wide, K, 1.0, 1e-6, rg, l1_counts=cnt, **kw)
        w2 = window_gq.node_window_gq_cuda(*wide, K, 1.0, 1e-6, rg, window_bytes=0, **kw)
        torch.cuda.synchronize()
        assert cnt.tolist() == [window_gq.window_ctas(big), math.prod(big)]
        assert all(torch.equal(g, w) for g, w in zip(w1, w2))
    _, M, N = st[0].shape
    for r0, c0, m, n in ((0, 0, M // 2, N // 2), (M // 2, N // 3, M - M // 2, N - N // 3),
                         (3, 5, M - 6, N - 7)):
        blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
        got = window_gq.node_window_gq_cuda(I1, VV, *(x[blk].contiguous() for x in st), K, 1.0,
                                            1e-6, rg, origin=(r0, c0), local_image_shape=(m, n),
                                            **kw)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[blk])


def test_window_gq_v2_instances_hold_no_arrays_in_local_memory(dev):
    # every float32 v2 instance (K = 9 and the runtime K, rg 1 to 4) keeps its
    # arrays in registers: no local memory, no spill; v1's compiled instance
    # neither; the resident CTAs an SM are those its registers allow
    for rg in range(1, window_gq.MAX_RG + 1):
        for generic in (False, True):
            occ = window_gq.occupancy(9, rg, torch.float32, "v2", generic=generic, device=dev)
            assert occ["local_bytes"] == 0, (rg, generic, occ)
            assert occ["ctas_per_sm"] >= 2, (rg, generic, occ)
    assert window_gq.occupancy(9, 2, torch.float32, "v1", device=dev)["local_bytes"] == 0


def test_window_gq_kernel_refuses_what_it_does_not_take(dev):
    args, K, rg = _k12_args(dev, torch.float32, "ragged rg=1", "converged")
    n = window_gq.node_window_gq_cuda.launches
    for bad_K, bad_rg in ((17, 2), (9, 0), (9, window_gq.MAX_RG + 1)):
        with pytest.raises(ValueError, match="takes rules"):
            window_gq.node_window_gq_cuda(*args, bad_K, 1.0, 1e-6, bad_rg)
    with pytest.raises(ValueError, match="VV"):
        window_gq.node_window_gq_cuda(args[0], args[1][1:], *args[2:], K, 1.0, 1e-6, rg)
    for variant in window_gq.VARIANTS:
        with pytest.raises(ValueError, match="window_bytes"):
            window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, window_bytes=64 * 1024,
                                          variant=variant)
    with pytest.raises(ValueError, match="unknown window_gq kernel variant"):
        window_gq.node_window_gq_cuda(*args, K, 1.0, 1e-6, rg, variant="v3")
    assert window_gq.node_window_gq_cuda.launches == n


@pytest.mark.parametrize("preset, kw", [("full_mixture", dict(window_rg=2, quad_chunk=7)),
                                        ("legacy_v2", dict(data_term="bicubic"))])
def test_windowed_bicubic_solve_launches_k12(dev, preset, kw):
    # the windowed bicubic term through the user entry point: K12 once a
    # sweep, K4 and the plain sums never, K3 and K8 v2 (its tail in its last
    # CTA) beside it
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (24, 40))
    cfg = getattr(GQMAPConfig, preset)(its=3, eval_every=3, **kw)
    n = [k.launches for k in COUNTED]
    res = pg.solve(cfg, I1, np.roll(I1, 1, axis=1), flow_range=FlowRange(-2, 2, -2, 2),
                   device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    assert [k.launches - m for k, m in zip(COUNTED, n)] == [0, 0, 3, 0, 0, 0, 0, 3, 0, 3, 0, 0,
                                                            3, 0, 0, 0, 0]


def test_windowed_bicubic_graph_segment_launches_k12(dev):
    # full_mixture(window_rg=2)'s segment on the graph route: K12 and K3 once a
    # replayed sweep, bit for bit the host loop's
    cfg, problem, state = _graph_toy(dev, "full_mixture", window_rg=2, quad_chunk=7)
    h, _ = _counted(pg.SegmentRunner(cfg, (24, 40), _route="host"), problem, state, 20)
    seg = pg.make_segment_runner(cfg, (24, 40))
    g, counts = _counted(seg, problem, state, 20)
    assert seg.route == "graph" and _identical(g, h)
    assert counts == [0, 0, 20, 0, 0, 0, 0, 20, 0, 20, 0, 0, 20, 0, 0, 0, 0]


# K5 (the Chebyshev series' node quadrature): the coefficient field of a
# smoothed random pair over chip_smoke.py's flow box, at the presets' degrees
# on 376x452 (full_mixture's 96 x 16, tpu_fast's 64 x 16, the super lattice
# of 4x4 blocks), the config default 96 x 32, a window-meaned field, ragged
# lattices and rules (Q = 8, 6: zero-padded columns), Q = 48 (the 64-wide
# instance) and a field of 200 x 64 whose f64 block is staged a chunk of rows
# at a time: (L, K, P, Q, frame, patch, window_rg)
K5_CASES = {
    "full_mixture 96x16": (3, 9, 96, 16, (376, 452), 1, 0),
    "tpu_fast 64x16": (3, 9, 64, 16, (376, 452), 1, 0),
    "super 96x16 patch 4": (3, 9, 96, 16, (376, 452), 4, 0),
    "default 96x32": (3, 9, 96, 32, (96, 128), 1, 0),
    "window_rg 2": (3, 9, 24, 8, (48, 64), 1, 2),
    "ragged K=5 L=2 24x8": (2, 5, 24, 8, (37, 53), 1, 0),
    "ragged K=11 L=1 13x6": (1, 11, 13, 6, (29, 31), 1, 0),
    "Q=48": (3, 5, 40, 48, (24, 40), 1, 0),
    "chunked 200x64": (2, 5, 200, 64, (20, 24), 1, 0),
}


def _k5_inputs(dev, dtype, L, P, Q, shape, patch, window_rg, probe):
    """A site-major field built on the card from a smoothed random pair, and
    the five state fields: the init's wide sigmas, sigma = 0.05, or the |rho|
    clamp with sigma per site in [0.01, 3]; means over the box's flow range,
    so samples leave the box."""
    from gqmap_tpu_torch.ops.chebyshev import build_cheb_data
    from gqmap_tpu_torch.ops.interp import pad_cubic

    g = torch.Generator().manual_seed(sum(shape) + L + P + Q)
    I1 = torch.nn.functional.avg_pool2d(
        255 * torch.rand((1, 1) + shape, generator=g, dtype=torch.float64), 5, 1, 2,
        count_include_pad=False)[0, 0]
    box = (-12.0, 4.0, -4.0, 4.0)  # chip_smoke.py's flow range and 2 px of margin
    cheb = build_cheb_data(I1.to(dev, dtype), pad_cubic(I1.roll(1, 1).to(dev, dtype)), 1.0,
                           1e-6, box, P, Q, patch=patch, window_rg=window_rg)
    M, N = shape[0] // patch, shape[1] // patch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((L, M, N), generator=g, dtype=torch.float64)

    pn = torch.zeros((L, M, N), dtype=torch.float64)
    if probe == "init":
        su, sv = u(12, 13), u(4, 5)
    elif probe == "converged":
        su = sv = torch.full((L, M, N), 0.05, dtype=torch.float64)
    else:
        su, sv = u(0.01, 3), u(0.01, 3)
        pn = 0.99999 * torch.where(u(0, 1) < 0.5, -1.0, 1.0)
    return cheb, [x.to(dev, dtype) for x in (u(-10, 2), u(-2, 2), su, sv, pn)]


# (dtype, variant): float64 runs "v1" alone, float32 both
K5_RUNS = [(torch.float64, "v1"), (torch.float32, "v1"), (torch.float32, "v2")]


def _k5_takes(cheb, st, K, dtype, variant):
    """Whether ``variant`` takes the launch (``cheb_gq.resolve_variant``)."""
    L = st[0].shape[0]
    P, Q = cheb.coeffs.shape[:2]
    try:
        cheb_gq.resolve_variant(variant, dtype, L, K, P, Q, cheb.coeffs.data_ptr() % 16 == 0)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype, variant", K5_RUNS)
@pytest.mark.parametrize("case", list(K5_CASES))
def test_cheb_gq_kernel_matches_plain(dev, case, dtype, variant, probe):
    # float64 within 1e-10 of each sum's largest magnitude; float32 held to
    # the f64 golden on the same inputs (ratio rule). A shape "v2" does not
    # take (P Q not a multiple of 4, a stage over its shared memory) raises
    # for an explicit "v2" before a launch, and the default runs "v1" there,
    # bit for bit
    L, K, P, Q, shape, patch, window_rg = K5_CASES[case]
    cheb, st = _k5_inputs(dev, dtype, L, P, Q, shape, patch, window_rg, probe)
    n = cheb_gq.cheb_gq_cuda.launches
    if not _k5_takes(cheb, st, K, dtype, variant):
        with pytest.raises(ValueError, match="'v2' takes float32"):
            cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=variant)
        assert cheb_gq.cheb_gq_cuda.launches == n
        default, v1 = (cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=v) for v in (None, "v1"))
        assert all(torch.equal(a, b) for a, b in zip(default, v1))
        return
    got = cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=variant)
    torch.cuda.synchronize()
    assert cheb_gq.cheb_gq_cuda.launches == n + 1
    plain = cheb_gq.cheb_gq_torch(cheb, *st, K, quad_chunk=27)
    if dtype == torch.float64:
        for name in plain._fields:
            _close(getattr(got, name), getattr(plain, name), dtype, name)
    else:
        cheb64 = cheb._replace(coeffs=cheb.coeffs.double())
        gold = cheb_gq.cheb_gq_torch(cheb64, *(x.double() for x in st), K, quad_chunk=27)
        _ratio_to_golden(got, plain, gold)


@pytest.mark.parametrize("dtype, variant", K5_RUNS)
@pytest.mark.parametrize("case", ["full_mixture 96x16", "ragged K=5 L=2 24x8"])
def test_cheb_gq_kernel_nan_probe(dev, case, dtype, variant):
    # NaN means, sigmas and correlations at a few sites: NaN exactly there in
    # the kernel and its plain version, every other site and component as
    # the NaN-free call gives it, bit for bit
    L, K, P, Q, shape, patch, window_rg = K5_CASES[case]
    cheb, st = _k5_inputs(dev, dtype, L, P, Q, shape, patch, window_rg, "converged")
    clean = cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=variant)
    _, M, N = st[0].shape
    sites = [(0, 1, 2), (L - 1, M // 2, N // 3), (L - 1, M - 1, N - 1), (0, 0, N // 2)]
    mask = torch.zeros((L, M, N), dtype=torch.bool, device=dev)
    for field, site in zip((0, 1, 3, 4), sites):  # muu, muv, sv, pn
        st[field] = st[field].clone()
        st[field][site] = float("nan")
        mask[site] = True
    got = cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=variant)
    plain = cheb_gq.cheb_gq_torch(cheb, *st, K)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, clean):
        assert torch.equal(torch.isnan(g), mask) and torch.equal(torch.isnan(p), mask)
        assert torch.equal(g[~mask], c[~mask])


@pytest.mark.parametrize("dtype, variant", K5_RUNS)
@pytest.mark.parametrize("case", ["full_mixture 96x16", "super 96x16 patch 4",
                                  "ragged K=5 L=2 24x8"])
def test_cheb_gq_kernel_on_a_block_equals_the_whole(dev, case, dtype, variant):
    # a shard's block of the field (site major, as parallel/sharded.py stores
    # it) and of the state: the block's sums are the whole lattice's there,
    # bit for bit, whatever CTAs hold its sites
    from gqmap_tpu_torch.ops.chebyshev import site_major

    L, K, P, Q, shape, patch, window_rg = K5_CASES[case]
    cheb, st = _k5_inputs(dev, dtype, L, P, Q, shape, patch, window_rg, "converged")
    whole = cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=variant)
    _, M, N = st[0].shape
    for r0, c0, m, n in ((0, 0, M // 2, N // 2), (M // 2, N // 3, M - M // 2, N - N // 3),
                         (3, 5, M - 6, N - 7)):
        blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
        block = cheb._replace(coeffs=site_major(cheb.coeffs[:, :, r0:r0 + m, c0:c0 + n]))
        got = cheb_gq.cheb_gq_cuda(block, *(x[blk].contiguous() for x in st), K,
                                   variant=variant)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[blk])


@pytest.mark.parametrize("variant", cheb_gq.VARIANTS)
def test_cheb_gq_kernel_refuses_a_field_that_is_not_site_major(dev, variant):
    # the kernel reads each site's block as one run and never copies the
    # field: the plain (P, Q, M, N) layout, or a block of the site-major one,
    # raises before a launch
    L, K, P, Q, shape, patch, window_rg = K5_CASES["ragged K=5 L=2 24x8"]
    cheb, st = _k5_inputs(dev, torch.float32, L, P, Q, shape, patch, window_rg, "converged")
    n = cheb_gq.cheb_gq_cuda.launches
    for coeffs in (cheb.coeffs.contiguous(), cheb.coeffs[:, :, :, 1:]):
        with pytest.raises(ValueError, match="site major"):
            cheb_gq.cheb_gq_cuda(cheb._replace(coeffs=coeffs), *st, K, variant=variant)
    with pytest.raises(ValueError, match="v-degrees"):
        cheb_gq.cheb_gq_cuda(cheb._replace(coeffs=torch.zeros(
            (4, 65) + tuple(st[0].shape[1:]), device=dev).permute(2, 3, 0, 1).contiguous()
            .permute(2, 3, 0, 1)), *st, K, variant=variant)
    assert cheb_gq.cheb_gq_cuda.launches == n


@pytest.mark.parametrize("case", ["full_mixture 96x16", "super 96x16 patch 4", "default 96x32"])
def test_cheb_gq_v2_launches_are_bit_for_bit_equal(dev, case):
    # fixed tiles, chains and trees, no atomics: two launches, one result
    L, K, P, Q, shape, patch, window_rg = K5_CASES[case]
    cheb, st = _k5_inputs(dev, torch.float32, L, P, Q, shape, patch, window_rg, "init")
    n = cheb_gq.cheb_gq_cuda.launches
    a, b = (cheb_gq.cheb_gq_cuda(cheb, *st, K, variant="v2") for _ in range(2))
    assert cheb_gq.cheb_gq_cuda.launches == n + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cheb_gq_resolve_variant_on_the_card(dev):
    # the default: "v2" for float32 where it takes the shape, "v1" for
    # float64, for P Q not a multiple of 4 and for a field whose first element
    # is not 16-byte aligned, each bit for bit the explicit variant; an
    # explicit "v2" there and an unknown variant raise before a launch
    def sums(cheb, st, K, variant):
        return cheb_gq.cheb_gq_cuda(cheb, *st, K, variant=variant)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    L, K, P, Q, shape, patch, window_rg = K5_CASES["ragged K=5 L=2 24x8"]
    for dtype, want in ((torch.float32, "v2"), (torch.float64, "v1")):
        cheb, st = _k5_inputs(dev, dtype, L, P, Q, shape, patch, window_rg, "converged")
        assert same(sums(cheb, st, K, None), sums(cheb, st, K, want))
    # misaligned: the same site-major values one element into a buffer
    cheb, st = _k5_inputs(dev, torch.float32, L, P, Q, shape, patch, window_rg, "converged")
    _, M, N = st[0].shape
    buf = torch.empty(M * N * P * Q + 1, device=dev)
    buf[1:] = cheb.coeffs.permute(2, 3, 0, 1).reshape(-1)
    odd = cheb._replace(coeffs=buf[1:].view(M, N, P, Q).permute(2, 3, 0, 1))
    assert odd.coeffs.data_ptr() % 16 != 0 and torch.equal(odd.coeffs, cheb.coeffs)
    assert same(sums(odd, st, K, None), sums(cheb, st, K, "v1"))
    L, K, P, Q, shape, patch, window_rg = K5_CASES["ragged K=11 L=1 13x6"]
    cheb13, st13 = _k5_inputs(dev, torch.float32, L, P, Q, shape, patch, window_rg, "converged")
    assert same(sums(cheb13, st13, K, None), sums(cheb13, st13, K, "v1"))
    n = cheb_gq.cheb_gq_cuda.launches
    for c, s, k, v in ((odd, st, 5, "v2"), (cheb13, st13, K, "v2"), (cheb, st, 5, "v3")):
        with pytest.raises(ValueError, match="variant"):
            sums(c, s, k, v)
    assert cheb_gq.cheb_gq_cuda.launches == n


@pytest.mark.parametrize("preset, kw, want", [
    ("full_mixture", dict(quad_chunk=7), [0, 0, 3, 0, 3, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0]),
    ("tpu_fast", {}, [0, 3, 0, 0, 3, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0]),
    ("super_entropy", {}, [0, 0, 3, 0, 3, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0]),
    ("tpu_fast", dict(window_rg=2), [0, 3, 0, 0, 3, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0]),
    ("full_mixture", dict(quad_chunk=7, sweep_order="redblack"),
     [0, 0, 6, 0, 6, 0, 0, 6, 0, 3, 0, 0, 0, 0, 0, 0, 0]),
    ("full_mixture", dict(quad_chunk=7, gradient_estimator="autodiff"),
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0, 0]),
    ("tpu_fast", dict(gradient_estimator="autodiff"),
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0]),
])
def test_chebyshev_solve_launches_k5(dev, preset, kw, want):
    # every Stein path of the Chebyshev term: K5 once a node-term evaluation
    # (twice a red-black sweep), beside K3 (full_mixture, super_entropy) or
    # K2 (tpu_fast); under autodiff the Chebyshev term stays plain and only
    # the edges launch (K14 on full_mixture's tensor rule, K15 on tpu_fast's
    # reduced one)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (32, 48))
    I2 = np.roll(I1, 1, axis=1)
    cfg = getattr(GQMAPConfig, preset)(its=3, eval_every=3, data_term="chebyshev", cheb_p=24,
                                       cheb_q=8, **kw)
    n = [k.launches for k in COUNTED]
    res = pg.solve(cfg, I1, I2, flow_range=FlowRange(-2, 2, -2, 2), device=dev)
    assert res.iters == 3 and np.isfinite(res.Energy).all()
    assert [k.launches - m for k, m in zip(COUNTED, n)] == want


# K6 (the nearest lookup's node quadrature) at the main paths' shapes on
# 376x452 at rfc = 6: legacy_v2's windowed L = 1 lattice at K = 9, rg = 2,
# blockmatch_v2's at K = 17, full_mixture(data_term="nearest")'s L = 3 at
# K = 9; a ragged lattice (a partial last tile, rg = 1) and a window of the
# run-time instance (rg = 4): (L, K, rg, rfc, frame)
K6_CASES = {
    "legacy_v2": (1, 9, 2, 6, (376, 452)),
    "blockmatch_v2": (1, 17, 0, 6, (376, 452)),
    "full_mixture nearest": (3, 9, 0, 6, (376, 452)),
    "ragged rg=1": (2, 5, 1, 3, (37, 53)),
    "run-time rg=4": (1, 5, 4, 2, (24, 40)),
}
# K7 (the Prewitt chain): legacy_v3's L = 1 lattice at K = 9, rfc = 4, and a
# ragged one: (L, K, rfc, frame)
K7_CASES = {"legacy_v3": (1, 9, 4, (376, 452)), "ragged": (2, 5, 3, (37, 53))}


def _nearest_inputs(dev, dtype, L, rfc, shape, probe, chain=False):
    """Frame 1, the upsampled frame 2 (and, for ``chain``, its upsampled
    Prewitt fields) and the five state fields of ``_k4_inputs``' probes, one
    pixel a site; and ``dict(pads=...)``, the padded fields ``"v2"`` reads."""
    from gqmap_tpu_torch.ops.interp import pad_cubic, prewitt_gradients, upsample_cubic

    g = torch.Generator().manual_seed(sum(shape) + L + rfc)
    I1 = 255 * torch.rand(shape, generator=g, dtype=torch.float64)
    I2 = I1.roll(1, 1).to(dev, dtype)
    fields = (I2, *prewitt_gradients(I2)) if chain else (I2,)
    tabs = [upsample_cubic(x, rfc) for x in fields]
    st = _k4_inputs(dev, dtype, L, 1, shape, probe)[2:]
    return (I1.to(dev, dtype), *tabs, *st), dict(pads=tuple(pad_cubic(x) for x in fields))


@pytest.mark.parametrize("variant", nearest_gq.VARIANTS)
@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K6_CASES))
def test_nearest_gq_kernel_matches_plain(dev, case, dtype, probe, variant):
    # float64 within 1e-10 of each sum's largest magnitude; float32 held to
    # the f64 golden on the same inputs (ratio rule)
    L, K, rg, rfc, shape = K6_CASES[case]
    args, pads = _nearest_inputs(dev, dtype, L, rfc, shape, probe)
    rest = (K, 0.3, 1e-4, rfc, rg)
    n = nearest_gq.nearest_gq_cuda.launches
    got = nearest_gq.nearest_gq_cuda(*args, *rest, variant=variant, **pads)
    torch.cuda.synchronize()
    assert nearest_gq.nearest_gq_cuda.launches == n + 1
    plain = nearest_gq.nearest_gq_torch(*args, *rest, quad_chunk=27)
    if dtype == torch.float64:
        for name in plain._fields:
            _close(getattr(got, name), getattr(plain, name), dtype, name)
    else:
        gold = nearest_gq.nearest_gq_torch(*(x.double() for x in args), *rest, quad_chunk=27)
        _ratio_to_golden(got, plain, gold)


@pytest.mark.parametrize("variant", nearest_gq.VARIANTS)
@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K7_CASES))
def test_nearest_chain_kernel_matches_plain(dev, case, dtype, probe, variant):
    L, K, rfc, shape = K7_CASES[case]
    args, pads = _nearest_inputs(dev, dtype, L, rfc, shape, probe, chain=True)
    rest = (K, 1.0, 1e-4, rfc)
    n = nearest_gq.nearest_chain_gq_cuda.launches
    got = nearest_gq.nearest_chain_gq_cuda(*args, *rest, variant=variant, **pads)
    torch.cuda.synchronize()
    assert nearest_gq.nearest_chain_gq_cuda.launches == n + 1
    plain = nearest_gq.nearest_chain_gq_torch(*args, *rest, quad_chunk=27)
    if dtype == torch.float64:
        for name in plain._fields:
            _close(getattr(got, name), getattr(plain, name), dtype, name)
    else:
        gold = nearest_gq.nearest_chain_gq_torch(*(x.double() for x in args), *rest,
                                                 quad_chunk=27)
        _ratio_to_golden(got, plain, gold)


@pytest.mark.parametrize("probe", ["init", "converged", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K6_CASES) + [f"K7 {c}" for c in K7_CASES])
def test_nearest_v2_equals_v1_bit_for_bit(dev, case, dtype, probe):
    # "v2" evaluates each cell from the pads by the table's own chain (the
    # step addcmul_ takes on the card) and sums in v1's order with v1's
    # roundings: the same sums, bit for bit
    chain = case.startswith("K7 ")
    if chain:
        L, K, rfc, shape = K7_CASES[case[3:]]
        rest, fn = (K, 1.0, 1e-4, rfc), nearest_gq.nearest_chain_gq_cuda
    else:
        L, K, rg, rfc, shape = K6_CASES[case]
        rest, fn = (K, 0.3, 1e-4, rfc, rg), nearest_gq.nearest_gq_cuda
    args, pads = _nearest_inputs(dev, dtype, L, rfc, shape, probe, chain=chain)
    v1 = fn(*args, *rest, variant="v1")
    v2 = fn(*args, *rest, variant="v2", **pads)
    torch.cuda.synchronize()
    for name, a, b in zip(v1._fields, v1, v2):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


def _nearest_call(kind, args, **at):
    """K6 at rg = 2 or K7 on ``args`` (frame, tables, state) in ``variant``
    (``at``, with the pads)."""
    if kind == "K7":
        return nearest_gq.nearest_chain_gq_cuda(*args, 9, 1.0, 1e-4, 4, **at)
    return nearest_gq.nearest_gq_cuda(*args, 9, 0.3, 1e-4, 3, 2, **at)


@pytest.mark.parametrize("variant", nearest_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["K6", "K7"])
def test_nearest_kernels_nan_probe(dev, kind, dtype, variant):
    # NaN means, sigmas and correlations at a few sites: a NaN query reads
    # the element the plain version reads (a NaN cell is -1, the flat index
    # wraps), so the sums are NaN where the plain version's are and within
    # tolerance of it elsewhere; every other site bit for bit the NaN-free
    # call's
    rfc = 4 if kind == "K7" else 3
    args, pads = _nearest_inputs(dev, dtype, 3, rfc, (64, 96), "converged", chain=kind == "K7")
    args = list(args)
    at = dict(pads, variant=variant)
    clean = _nearest_call(kind, args, **at)
    first = 4 if kind == "K7" else 2  # muu's position in args
    _, M, N = args[first].shape
    sites = [(0, 1, 2), (1, M // 2, N // 3), (2, M - 1, N - 1), (1, 0, N // 2)]
    mask = torch.zeros((3, M, N), dtype=torch.bool, device=dev)
    for field, site in zip((0, 1, 3, 4), sites):  # muu, muv, sv, pn
        args[first + field] = args[first + field].clone()
        args[first + field][site] = float("nan")
        mask[site] = True
    got = _nearest_call(kind, args, **at)
    rest = ((9, 1.0, 1e-4, 4) if kind == "K7" else (9, 0.3, 1e-4, 3, 2))
    plain = (nearest_gq.nearest_chain_gq_torch if kind == "K7"
             else nearest_gq.nearest_gq_torch)(*args, *rest)
    torch.cuda.synchronize()
    for name, g, p, c in zip(plain._fields, got, plain, clean):
        assert torch.equal(torch.isnan(g), torch.isnan(p)), name
        assert not torch.isnan(g[~mask]).any() and torch.equal(g[~mask], c[~mask]), name
        ok = ~torch.isnan(p)
        _close(g[ok], p[ok], dtype, name)


@pytest.mark.parametrize("variant", nearest_gq.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["K6", "K7"])
def test_nearest_kernels_on_a_block_equal_the_whole(dev, kind, dtype, variant):
    # frame 1 addressed at a shard's pixel origin (K6's window taps across
    # the cut read the true neighbours): the block's sums are the whole
    # lattice's there, bit for bit; two launches are equal bit for bit
    rfc = 4 if kind == "K7" else 3
    args, pads = _nearest_inputs(dev, dtype, 2, rfc, (64, 96), "converged", chain=kind == "K7")
    at = dict(pads, variant=variant)
    first = 4 if kind == "K7" else 2
    frames, st = args[:first], args[first:]
    whole = _nearest_call(kind, args, **at)
    again = _nearest_call(kind, args, **at)
    assert all(torch.equal(a, b) for a, b in zip(whole, again))
    _, M, N = st[0].shape
    for r0, c0, m, n in ((0, 0, M // 2, N // 2), (M // 2, N // 3, M - M // 2, N - N // 3),
                         (3, 5, M - 6, N - 7)):
        blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
        got = _nearest_call(kind, (*frames, *(x[blk].contiguous() for x in st)),
                            origin=(r0, c0), local_image_shape=(m, n), **at)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[blk])


def test_nearest_variant_rule_and_refusals(dev):
    # None runs "v2" where it takes the shape (and then needs the pads),
    # "v1" elsewhere (K > 24: the same sums as an explicit "v1"); an explicit
    # "v2" outside its shape raises before a launch
    args, pads = _nearest_inputs(dev, torch.float32, 1, 3, (24, 40), "converged")
    n = nearest_gq.nearest_gq_cuda.launches
    with pytest.raises(ValueError, match="pass pads="):
        nearest_gq.nearest_gq_cuda(*args, 9, 1.0, 1e-4, 3)
    with pytest.raises(ValueError, match="at most 24 points"):
        nearest_gq.nearest_gq_cuda(*args, 25, 1.0, 1e-4, 3, variant="v2", **pads)
    with pytest.raises(ValueError, match="unknown nearest_gq kernel variant"):
        nearest_gq.nearest_gq_cuda(*args, 9, 1.0, 1e-4, 3, variant="v3", **pads)
    with pytest.raises(ValueError, match="pad 0 has shape"):
        nearest_gq.nearest_gq_cuda(*args, 9, 1.0, 1e-4, 3, pads=(pads["pads"][0][1:],))
    assert nearest_gq.nearest_gq_cuda.launches == n
    wide = nearest_gq.nearest_gq_cuda(*args, 25, 1.0, 1e-4, 3, **pads)
    v1 = nearest_gq.nearest_gq_cuda(*args, 25, 1.0, 1e-4, 3, variant="v1")
    assert all(torch.equal(a, b) for a, b in zip(wide, v1))
    fine = nearest_gq.nearest_gq_cuda(*args, 9, 1.0, 1e-4, 3, **pads)
    v2 = nearest_gq.nearest_gq_cuda(*args, 9, 1.0, 1e-4, 3, variant="v2", **pads)
    assert all(torch.equal(a, b) for a, b in zip(fine, v2))


@pytest.mark.parametrize("preset, counts", [
    ("legacy_v2", [0, 0, 20, 0, 0, 20, 0, 20, 0, 20, 0, 0, 0, 0, 0, 0, 0]),
    ("blockmatch_v2", [0, 0, 20, 0, 0, 20, 0, 20, 0, 20, 0, 0, 0, 0, 0, 0, 0]),
    ("legacy_v3", [0, 0, 20, 0, 0, 0, 20, 20, 0, 20, 0, 0, 0, 0, 0, 0, 0])])
def test_legacy_graph_segment_launches_k6_or_k7(dev, preset, counts):
    # the nearest-lookup presets' segments on the graph route: K3 and K6 (or
    # K7) once a replayed sweep
    cfg, problem, state = _graph_toy(dev, preset)
    seg = pg.make_segment_runner(cfg, (24, 40))
    _, got = _counted(seg, problem, state, 20)
    assert seg.route == "graph" and got == counts


def test_nearest_kernels_refuse_what_they_do_not_take(dev):
    # a lattice that is not the block of pixels at the origin, a rule over
    # 64 points an axis, and a strided table: ValueError before any launch
    args, _ = _nearest_inputs(dev, torch.float32, 1, 3, (24, 40), "converged")
    n = nearest_gq.nearest_gq_cuda.launches
    with pytest.raises(ValueError, match="does not cover"):
        nearest_gq.nearest_gq_cuda(*args, 9, 1.0, 1e-4, 3, origin=(1, 0))
    with pytest.raises(ValueError, match="rules of 1 to 64"):
        nearest_gq.nearest_gq_cuda(*args, 65, 1.0, 1e-4, 3)
    with pytest.raises(ValueError, match="contiguous"):
        nearest_gq.nearest_gq_cuda(args[0], args[1].t().contiguous().t(), *args[2:], 9, 1.0,
                                   1e-4, 3)
    assert nearest_gq.nearest_gq_cuda.launches == n


# K8 and K9 (the sweep's update, csrc/sweep_update.cu) on every path K8 takes,
# at a small size: (preset, overrides)
UPDATE_CASES = {
    "tpu_fast": ("tpu_fast", {}),
    "tpu_fast redblack": ("tpu_fast", dict(sweep_order="redblack")),
    "tpu_fast_super": ("tpu_fast_super", {}),
    "full_mixture": ("full_mixture", dict(quad_chunk=7)),
    "super_entropy": ("super_entropy", {}),
    "ctf_level": ("ctf_level", {}),
    "legacy_v1": ("legacy_v1", dict(quad_var=0.05)),
    "legacy_v2": ("legacy_v2", {}),
    "legacy_v3": ("legacy_v3", {}),
    "blockmatch_v2": ("blockmatch_v2", {}),
    "tpu_fast window": ("tpu_fast", dict(window_rg=2)),
    "tpu_fast chebyshev": ("tpu_fast", dict(data_term="chebyshev", cheb_p=24, cheb_q=8)),
    "full_mixture chebyshev": ("full_mixture", dict(data_term="chebyshev", cheb_p=24,
                                                    cheb_q=8)),
}


def _update_toy(dev, name, dtype, **over):
    preset, kw = UPDATE_CASES[name]
    cfg, problem, state = _graph_toy(dev, preset, dtype=str(dtype)[6:], **{**kw, **over})
    if cfg.data_term == "quadratic":
        problem = problem._replace(init_flow=torch.stack(
            [torch.ones_like(problem.I1), torch.zeros_like(problem.I1)], -1))
    return cfg, problem, state


def _update_probe(state, probe, corr_tor):
    g = torch.Generator(device=state.muu.device).manual_seed(11)

    def u(lo, hi, like):
        return lo + (hi - lo) * torch.rand(like.shape, generator=g, dtype=like.dtype,
                                           device=like.device)

    if probe == "random means":
        return state._replace(muu=u(-2, 2, state.muu), muv=u(-2, 2, state.muv),
                              sigmau=torch.full_like(state.sigmau, 0.05),
                              sigmav=torch.full_like(state.sigmav, 0.05),
                              pn=u(-0.9, 0.9, state.pn), rou=u(-0.9, 0.9, state.rou))
    if probe == "clamp":
        def sign(like):
            return torch.where(u(0, 1, like) < 0.5, -1.0, 1.0).to(like.dtype)

        return state._replace(rou=sign(state.rou) * corr_tor, pn=sign(state.pn) * corr_tor)
    return state


@pytest.mark.parametrize("probe", ["init", "random means", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_sweep_update_kernels_are_the_plain_glue(dev, name, dtype, probe):
    # one sweep through K8 and K9 and one through the plain glue (the same
    # node and edge kernels, models/gqmap._update_route forced): the new
    # state bit for bit; the energy and the |dmu| and |dsigma| means within
    # their summation order (f64 1e-12, f32 1e-4 relative)
    from gqmap_tpu_torch.kernels import sweep_update

    cfg, problem, state = _update_toy(dev, name, dtype)
    state = _update_probe(state, probe, cfg.corr_tor)
    assert pg._update_route(cfg, None, dev) == "K8"
    counters = (sweep_update.site_update_cuda, sweep_update.sweep_tail_v2,
                sweep_update.sweep_tail_cuda)
    n = [f.launches for f in counters]
    got, gaux = pg.make_sweep(cfg, (24, 40))(problem, state)
    passes = 2 if cfg.sweep_order == "redblack" else 1
    # K8 v2 once a pass, its tail (K9 v2) in the last, no K9 v1 launch
    assert [f.launches - m for f, m in zip(counters, n)] == [passes, 1, 0]
    kept = pg._update_route
    pg._update_route = lambda c, d, device: "plain"
    try:
        want, waux = pg.make_sweep(cfg, (24, 40))(problem, state)
    finally:
        pg._update_route = kept
    torch.cuda.synchronize()
    for f in ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for a, b in zip(gaux, waux):
        assert abs(float(a) - float(b)) <= tol * abs(float(b)), (float(a), float(b))


@pytest.mark.parametrize("mode", ["softmax_natural", "projsplx"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name, L", [("tpu_fast", 3), ("tpu_fast redblack", 3),
                                     ("full_mixture", 3), ("legacy_v1", 20)])
def test_sweep_tail_alpha_step_is_the_plain_versions(dev, name, L, dtype, mode):
    # K9's alpha step (it = alpha_start + 1) on K8's partials of one sweep,
    # against sweep_tail_torch on the same partials summed by torch: T and it
    # bit for bit; w, which the step moves, within dalpha's summation order
    # (f64: 1e-12 of sum |w| + 2 lr x the partials' magnitude, sum |w| for
    # the sums over components of the softmax and the projection's
    # threshold; f32: its error against the f64 golden at most twice the
    # plain version's plus 2^-22 of that magnitude). Twenty components: K9
    # takes any L.
    from gqmap_tpu_torch.kernels import sweep_update

    cfg, problem, state = _update_toy(dev, name, dtype, L=L, alpha_update=mode)
    state = _update_probe(state, "random means", cfg.corr_tor)
    g = torch.Generator(device=dev).manual_seed(13)
    r = torch.rand(L, generator=g, dtype=dtype, device=dev)
    w0 = 2 * r - 1 if mode == "softmax_natural" else (r + 0.1) / (r + 0.1).sum()
    state = state._replace(w=w0, it=torch.full_like(state.it, cfg.alpha_start + 1))
    assert pg._update_route(cfg, None, dev) == "K8"
    tails = []

    def tail(*a, **k):
        out = sweep_update.sweep_tail_cuda(*a, **k)
        tails.append((a, out))
        return out

    kept = pg._UPDATE["K8"]
    pg._UPDATE["K8"], pg.UPDATE_VARIANT["K8"] = (kept[0], tail), "v1"  # K9 v1, a launch
    try:
        got, _ = pg.make_sweep(cfg, (24, 40))(problem, state)
    finally:
        pg._UPDATE["K8"], pg.UPDATE_VARIANT["K8"] = kept, "v2"
    (parts, st0, step, c, n_int), (w, T, it, _) = tails[0]

    def sums(ps):
        return [(p[..., 0].sum(), p[..., 1].sum(1), p[..., 2].sum(), p[..., 3].sum())
                for p in ps]

    pw, pT, pit, _ = sweep_update.sweep_tail_torch(sums(parts), st0, step, c, n_int)
    torch.cuda.synchronize()
    assert w.shape == (L,) and torch.equal(got.w, w)
    assert torch.equal(T, pT) and torch.equal(it, pit)
    assert not torch.equal(pw, st0.w)  # the step moved w
    mag = (float(pw.double().abs().sum()) + 2.0 * float(step) * c.alpha_lr_scale
           * float(parts[-1][..., 1].double().abs().sum(1).max()))
    if dtype == torch.float64:
        assert bool(((w - pw).abs() <= 1e-12 * mag).all()), (w, pw)
    else:
        gold = sweep_update.sweep_tail_torch(
            sums([p.double() for p in parts]), st0._replace(
                w=st0.w.double(), temperature=st0.temperature.double()),
            step.double(), c, n_int)[0]
        ek, ep = (w.double() - gold).abs(), (pw.double() - gold).abs()
        assert bool((ek <= 2.0 * ep + 2.0 ** -22 * mag).all()), (ek, ep)


@pytest.mark.parametrize("name", ["tpu_fast", "full_mixture", "tpu_fast redblack", "legacy_v3"])
def test_sweep_update_segment_is_the_plain_glues(dev, name):
    # 30 sweeps (tor 0, before alpha_start) on the graph route through K8 and
    # K9 against the plain glue's graph: the state bit for bit; and the
    # graph through K8 and K9 bit for bit its own host loop
    cfg, problem, state = _update_toy(dev, name, torch.float32)
    cfg = dataclasses.replace(cfg, tor=0.0)
    seg = pg.make_segment_runner(cfg, (24, 40))
    got = seg(problem, state, 30)
    host = pg.SegmentRunner(cfg, (24, 40), _route="host")(problem, state, 30)
    kept = pg._update_route
    pg._update_route = lambda c, d, device: "plain"
    try:
        want = pg.make_segment_runner(cfg, (24, 40))(problem, state, 30)
    finally:
        pg._update_route = kept
    assert seg.route == "graph" and got[1] == want[1] == 30 and _identical(got, host)
    for f in ("w", "muu", "muv", "sigmau", "sigmav", "pn", "rou", "temperature", "it"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f


def test_sweep_update_kernels_refuse_what_they_do_not_take(dev):
    from gqmap_tpu_torch.kernels import sweep_update

    cfg, problem, state = _update_toy(dev, "full_mixture", torch.float32)
    calls = []

    def grab(*a, **k):
        calls.append((a, k))
        return sweep_update.site_update_cuda(*a, **k)

    kept = pg._UPDATE["K8"]
    pg._UPDATE["K8"] = (grab, kept[1])
    try:
        pg.make_sweep(cfg, (24, 40))(problem, state)
    finally:
        pg._UPDATE["K8"] = kept
    (node, edge, st, alpha, T, step, interior, c, rng), kw = calls[0]
    n = sweep_update.site_update_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        sweep_update.site_update_cuda(node, edge, st._replace(muu=st.muu.transpose(1, 2)
                                                              .contiguous().transpose(1, 2)),
                                      alpha, T, step, interior, c, rng)
    with pytest.raises(ValueError, match="node fields"):
        sweep_update.site_update_cuda(node._replace(fields=node.fields[:5]), edge, st, alpha, T,
                                      step, interior, c, rng)
    with pytest.raises(ValueError, match="float32"):
        sweep_update.site_update_cuda(node, edge, st, alpha.double(), T, step, interior, c, rng)
    with pytest.raises(TypeError, match="tensor"):
        sweep_update.site_update_cuda(node, edge, st, alpha, 0.0, step, interior, c, rng)
    with pytest.raises(ValueError, match="colour"):
        sweep_update.site_update_cuda(node, edge, st, alpha, T, step, interior, c, rng, colour=2)
    assert sweep_update.site_update_cuda.launches == n


# ---- K10 and K11: the quadratic prior's node sums, truncated-quadratic tensor edges

QUAD_RULES = ((9, False), (9, True), (5, True))  # (K, generic): K = 9's instance, the generic
QUAD_FLOOR = {torch.float64: 1e-13, torch.float32: 1e-5}  # of the largest |Ei|


def _quad_inputs(dev, probe, L, M, N, seed=0):
    """The sites, the prior and the edge stacks of a probe, float64: the init
    (wide sigma, no correlation), warm (sigma in [0.01, 3], |p|, |rho| <=
    0.9) or the clamp (every correlation at +-0.99999)."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)).to(dev)

    muu, muv = u(-10, 2, L, M, N), u(-2, 2, L, M, N)
    su, sv = (u(12, 13, L, M, N), u(4, 5, L, M, N)) if probe == "init" else (
        u(0.01, 3, L, M, N), u(0.01, 3, L, M, N))
    if probe == "init":
        pn, rou = torch.zeros_like(muu), torch.zeros((2, 2, L, M, N), dtype=torch.float64,
                                                     device=dev)
    elif probe == "warm":
        pn, rou = u(-0.9, 0.9, L, M, N), u(-0.9, 0.9, 2, 2, L, M, N)
    else:
        pn = 0.99999 * torch.sign(u(-1, 1, L, M, N))
        rou = 0.99999 * torch.sign(u(-1, 1, 2, 2, L, M, N))
    mu, sg = torch.stack([muu, muv]), torch.stack([su, sv])
    return (muu, muv, su, sv, pn), u(-10, 2, M, N, 2), (mu, sg, *edge_reduced_gq.neighbour_stacks(
        mu, sg), rou)


@pytest.mark.parametrize("K, generic", QUAD_RULES)
@pytest.mark.parametrize("probe", ["init", "warm", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L, M, N", [(1, 24, 40), (20, 12, 14), (3, 37, 53)])
def test_quad_gq_kernels_match_plain(dev, L, M, N, dtype, probe, K, generic):
    # K10 and K11 against their plain versions on the card: legacy_v1's L = 1,
    # the update phase's L = 20 and a ragged lattice (a partial last block);
    # float32 at the clamp against the f64 golden (ratio rule)
    site, prior, edge = _quad_inputs(dev, probe, L, M, N)
    node_rest, edge_rest = (K, 0.05), (K, 1.0, 10.0)
    cast = [x.to(dtype) for x in site], prior.to(dtype), [x.to(dtype) for x in edge]
    pairs = (
        (quad_gq.quad_node_gq_cuda(cast[1], *cast[0], *node_rest, generic=generic),
         quad_gq.quad_node_gq_torch(cast[1], *cast[0], *node_rest),
         lambda: quad_gq.quad_node_gq_torch(prior, *site, *node_rest)),
        (quad_gq.truncquad_edge_gq_cuda(*cast[2], *edge_rest, generic=generic),
         quad_gq.truncquad_edge_gq_torch(*cast[2], *edge_rest),
         lambda: quad_gq.truncquad_edge_gq_torch(*edge, *edge_rest)))
    for got, plain, golden in pairs:
        if dtype == torch.float32 and probe == "clamp":
            _ratio_to_golden(got, plain, golden())
            continue
        # a floor of the largest |Ei| (the size of the terms every sum adds):
        # K10's Sxy at p = 0 is zero in exact arithmetic, rounding noise here
        floor = QUAD_FLOOR[dtype] * float(plain.Ei.abs().max())
        scaled, rel = TOL[dtype]
        for name in plain._fields:
            g, w = getattr(got, name), getattr(plain, name)
            bound = scaled * w.abs().max() + rel * w.abs() + floor
            assert bool(((g - w).abs() <= bound).all()), (name, float((g - w).abs().max()))


def _unit_rule(K, monkeypatch):
    """``quad_gq.unit_rule`` patched in (Ei the sum of -d^2 / (2 gama) over
    the samples inside the cutoff); the plain version's table under the same
    rule."""
    for name, fn in quad_gq.unit_rule(K).items():
        monkeypatch.setattr(quad_gq, name, fn)
    tab = torch.as_tensor(np.stack(build_table(K, 0, np.float64)))
    tab[2] = 1.0
    return tab


def _cutoff_flips(dev, args, tab, K, gama, dta, near, monkeypatch, coop_lanes=None, **kw):
    """Samples of K11 (``kw``; v2's ``COOP_LANES`` set to ``coop_lanes``
    where given) on the other side of the cutoff from the plain version's
    under the unit rule, and the plain version's samples inside it among the
    elements ``near`` it."""
    with monkeypatch.context() as m:
        if coop_lanes is not None:
            m.setattr(quad_gq, "COOP_LANES", coop_lanes)
        got = quad_gq.truncquad_edge_gq_cuda(*args, K, gama, dta, **kw)
    tab = tab.to(dev, args[0].dtype)
    want = gq_accumulate(make_edge_pot_truncquad(gama, dta), args[0][None], args[2],
                         args[1][None], args[3], args[4], tab)
    inside = gq_accumulate(lambda x1, x2: ((x2 - x1).abs() <= dta).to(args[0].dtype),
                           args[0][None], args[2], args[1][None], args[3], args[4], tab).Ei
    flipped = int(((got.Ei - want.Ei).abs() / (dta * dta / (2 * gama))).round().sum())
    return flipped, float(inside[..., near].sum()) / (K * K * inside[..., near].numel())


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_truncquad_edge_kernel_puts_every_sample_on_the_plain_side_of_the_cutoff(dev, dtype,
                                                                                   generic,
                                                                                   monkeypatch):
    # neighbour means at +-dta from endpoint 1's within a few ulps, equal
    # sigmas at both ends: the diagonal points' d lies within rounding of the
    # cutoff. Under a rule of unit weights (monomials 0) Ei is the sum of
    # -d^2 / (2 gama) over the samples inside, so a sample on the other side
    # of the cutoff from the plain version's (|d| ~ dta there) changes a
    # site's Ei by about dta^2 / (2 gama): none may, in either variant (v2:
    # every element mixed, each of its forms forced too)
    g = torch.Generator().manual_seed(11)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)).to(dev)

    L, M, N, K, gama, dta = 1, 64, 96, 9, 1.0, 10.0
    edge = (2, 2, L, M, N)
    mu = u(-3, 3, 2, L, M, N)
    u2e = mu[None] + torch.sign(u(-1, 1, *edge)) * dta * (1 + u(-3e-7, 3e-7, *edge))
    sg = u(0.5, 3, 2, L, M, N)
    args = [x.to(dtype).contiguous() for x in (mu, sg, u2e, sg[None].expand(edge), u(-0.9, 0.9,
                                                                                 *edge))]
    tab = _unit_rule(K, monkeypatch)
    near = torch.ones((M, N), dtype=torch.bool, device=dev)
    for kw in (dict(variant="v1"), {}, dict(coop_lanes=0), dict(coop_lanes=32)):
        flipped, inside = _cutoff_flips(dev, args, tab, K, gama, dta, near, monkeypatch,
                                        generic=generic, **kw)
        assert 0.1 < inside < 0.9 and flipped == 0, (kw, flipped, inside)


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_truncquad_edge_v2_cooperative_form_keeps_the_cutoff(dev, dtype, generic, monkeypatch):
    # one element a warp at the cutoff (its neighbour mean at +-dta within
    # a few ulps), the others well inside with sigmas ~1e-3: every warp has
    # one mixed lane, which the cooperative form sums; no sample flipped,
    # the per-lane form's sums bit for bit
    g = torch.Generator().manual_seed(12)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)).to(dev)

    L, M, N, K, gama, dta = 1, 64, 96, 9, 1.0, 10.0
    edge = (2, 2, L, M, N)
    mu, sg = u(-3, 3, 2, L, M, N), u(1e-3, 2e-3, 2, L, M, N)
    near = (torch.arange(M * N, device=dev) % 32 == 7).reshape(M, N)
    u2e = mu[None] + torch.where(near, torch.sign(u(-1, 1, *edge)) * dta * (
        1 + u(-1e-7, 1e-7, *edge)), u(-1, 1, *edge))
    args = [x.to(dtype).contiguous() for x in (mu, sg, u2e, sg[None].expand(edge), u(-0.9, 0.9,
                                                                                 *edge))]
    tab = _unit_rule(K, monkeypatch)
    counts = torch.zeros(len(quad_gq.CLASS_COUNTS), dtype=torch.int64, device=dev)
    flipped, inside = _cutoff_flips(dev, args, tab, K, gama, dta, near, monkeypatch,
                                    generic=generic, counts=counts)
    c = dict(zip(quad_gq.CLASS_COUNTS, counts.tolist()))
    warps = 4 * M * N // 32
    assert c["mixed"] == c["mixed warps"] == c["cooperative warps"] == warps, c
    assert c["inside"] == 4 * M * N - warps and 0.1 < inside < 0.9 and flipped == 0
    a = quad_gq.truncquad_edge_gq_cuda(*args, K, gama, dta, generic=generic)
    monkeypatch.setattr(quad_gq, "COOP_LANES", 0)
    b = quad_gq.truncquad_edge_gq_cuda(*args, K, gama, dta, generic=generic)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("K, generic", QUAD_RULES)
@pytest.mark.parametrize("probe", ["init", "warm", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_quad_gq_v1_kernels_match_plain(dev, dtype, probe, K, generic):
    # v1 (the point loop), kept beside v2: against the plain versions, at
    # the clamp in float32 by the ratio rule
    site, prior, edge = _quad_inputs(dev, probe, 3, 37, 53, seed=1)
    cast = [x.to(dtype) for x in site], prior.to(dtype), [x.to(dtype) for x in edge]
    pairs = ((quad_gq.quad_node_gq_cuda(cast[1], *cast[0], K, 0.05, generic=generic,
                                        variant="v1"),
              quad_gq.quad_node_gq_torch(cast[1], *cast[0], K, 0.05),
              lambda: quad_gq.quad_node_gq_torch(prior, *site, K, 0.05)),
             (quad_gq.truncquad_edge_gq_cuda(*cast[2], K, 1.0, 10.0, generic=generic,
                                             variant="v1"),
              quad_gq.truncquad_edge_gq_torch(*cast[2], K, 1.0, 10.0),
              lambda: quad_gq.truncquad_edge_gq_torch(*edge, K, 1.0, 10.0)))
    for got, plain, golden in pairs:
        if dtype == torch.float32 and probe == "clamp":
            _ratio_to_golden(got, plain, golden())
            continue
        floor = QUAD_FLOOR[dtype] * float(plain.Ei.abs().max())
        scaled, rel = TOL[dtype]
        for name in plain._fields:
            g, w = getattr(got, name), getattr(plain, name)
            assert bool(((g - w).abs() <= scaled * w.abs().max() + rel * w.abs() + floor).all())


@pytest.mark.parametrize("probe", ["init", "warm", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_truncquad_edge_v2_matches_v1_on_mixed_elements(dev, dtype, probe, monkeypatch):
    # the elements v2 classifies mixed run its point loop: there v2's sums
    # (rows of column sums, a tree) are v1's (the point loop) within the
    # tolerance; each mixed form forced gives v2's sums bit for bit, and the
    # counters add up
    site, prior, edge = _quad_inputs(dev, probe, 2, 37, 53, seed=2)
    edge = [x.to(dtype) for x in edge]
    counts = torch.zeros(len(quad_gq.CLASS_COUNTS), dtype=torch.int64, device=dev)
    v2 = quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0, counts=counts)
    v1 = quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0, variant="v1")
    c = dict(zip(quad_gq.CLASS_COUNTS, counts.tolist()))
    assert c["inside"] + c["outside"] + c["mixed"] == v2.Ei.numel() and c["mixed"] > 0, c
    # every element, the mixed ones among them, within the tolerance of v1's
    floor = QUAD_FLOOR[dtype] * float(v1.Ei.abs().max())
    scaled, rel = TOL[dtype]
    for a, b in zip(v2, v1):
        assert bool(((a - b).abs() <= scaled * b.abs().max() + rel * b.abs() + floor).all())
    for lanes in (0, 32):
        forced = torch.zeros_like(counts)
        monkeypatch.setattr(quad_gq, "COOP_LANES", lanes)
        got = quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0, counts=forced)
        assert all(torch.equal(a, b) for a, b in zip(got, v2))
        f = dict(zip(quad_gq.CLASS_COUNTS, forced.tolist()))
        assert f["cooperative warps"] == (0 if lanes == 0 else f["mixed warps"])
        assert f["cooperative elements"] == (0 if lanes == 0 else f["mixed"])


def test_quad_gq_variants_on_the_card(dev):
    # v2 by default; v1 on request; counts are K11 v2's
    site, prior, edge = _quad_inputs(dev, "warm", 1, 8, 12)
    n = (quad_gq.quad_node_gq_cuda.launches, quad_gq.truncquad_edge_gq_cuda.launches)
    counts = torch.zeros(len(quad_gq.CLASS_COUNTS), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="K11 v2's"):
        quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0, variant="v1", counts=counts)
    with pytest.raises(ValueError, match="int64 tensor"):
        quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0, counts=counts[:5])
    with pytest.raises(ValueError, match="at most 32"):
        quad_gq.truncquad_edge_gq_cuda(*edge, 33, 1.0, 10.0, variant="v2")
    assert (quad_gq.quad_node_gq_cuda.launches, quad_gq.truncquad_edge_gq_cuda.launches) == n
    # K = 33: K11 runs v1 by default, K10 v2
    for kern, a, variant in ((quad_gq.truncquad_edge_gq_cuda, (*edge, 33, 1.0, 10.0), "v1"),
                             (quad_gq.quad_node_gq_cuda, (prior, *site, 33, 0.05), "v2")):
        got, want = kern(*a), kern(*a, variant=variant)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_quad_gq_kernels_nan_probe_and_block(dev, dtype):
    # NaN means, sigmas and correlations at a few sites: NaN exactly there
    # (as in the plain versions), every other site bit for bit the NaN-free
    # call's; a shard's block (its sites and a view of the prior's block)
    # bit for bit the whole lattice's sums there
    site, prior, edge = _quad_inputs(dev, "warm", 2, 24, 40, seed=3)
    site, prior, edge = [x.to(dtype) for x in site], prior.to(dtype), [x.to(dtype) for x in edge]
    base_n = quad_gq.quad_node_gq_cuda(prior, *site, 9, 0.05)
    base_e = quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0)
    bad = [(0, 3, 5), (1, 10, 0), (1, 23, 39)]
    for i, field in enumerate((0, 2, 4)):
        l, m, n = bad[i]
        s2 = [x.clone() for x in site]
        s2[field][l, m, n] = float("nan")
        got = quad_gq.quad_node_gq_cuda(prior, *s2, 9, 0.05)
        plain = quad_gq.quad_node_gq_torch(prior, *s2, 9, 0.05)
        for a, b, p in zip(got, base_n, plain):
            nan = torch.isnan(a)
            assert torch.equal(nan, torch.isnan(p)) and bool(nan[l, m, n]) and int(nan.sum()) == 1
            assert torch.equal(a[~nan], b[~nan])
        e2 = [x.clone() for x in edge]
        e2[4][1, 0, l, m, n] = float("nan")  # rho of one edge
        got = quad_gq.truncquad_edge_gq_cuda(*e2, 9, 1.0, 10.0)
        plain = quad_gq.truncquad_edge_gq_torch(*e2, 9, 1.0, 10.0)
        for a, b, p in zip(got, base_e, plain):
            nan = torch.isnan(a)
            assert torch.equal(nan, torch.isnan(p)) and int(nan.sum()) == 1
            assert torch.equal(a[~nan], b[~nan])
    blk = (slice(None), slice(5, 17), slice(3, 30))
    got = quad_gq.quad_node_gq_cuda(prior[5:17, 3:30], *(x[blk].contiguous() for x in site),
                                    9, 0.05)
    assert all(torch.equal(a, b[blk]) for a, b in zip(got, base_n))
    eblk = (slice(None), slice(None)) + blk
    got = quad_gq.truncquad_edge_gq_cuda(
        *(x[(slice(None),) + blk].contiguous() for x in edge[:2]),
        *(x[eblk].contiguous() for x in edge[2:]), 9, 1.0, 10.0)
    assert all(torch.equal(a, b[eblk]) for a, b in zip(got, base_e))


def test_quad_gq_kernels_refuse_what_they_do_not_take(dev):
    site, prior, edge = _quad_inputs(dev, "warm", 1, 8, 12)
    n = (quad_gq.quad_node_gq_cuda.launches, quad_gq.truncquad_edge_gq_cuda.launches)
    with pytest.raises(ValueError, match="prior has shape"):
        quad_gq.quad_node_gq_cuda(prior[:4], *site, 9, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        quad_gq.quad_node_gq_cuda(prior, site[0].transpose(1, 2).contiguous().transpose(1, 2),
                                  *site[1:], 9, 1.0)
    with pytest.raises(ValueError, match="device and dtype"):
        quad_gq.truncquad_edge_gq_cuda(edge[0].float(), *edge[1:], 9, 1.0, 10.0)
    with pytest.raises(ValueError, match="shape"):
        quad_gq.truncquad_edge_gq_cuda(*edge[:4], edge[4][:, :, :, :4], 9, 1.0, 10.0)
    assert (quad_gq.quad_node_gq_cuda.launches, quad_gq.truncquad_edge_gq_cuda.launches) == n


@pytest.mark.parametrize("kw", [{}, dict(quad_var=0.05)])
def test_legacy_v1_graph_segment_launches_k10_and_k11(dev, kw):
    # legacy_v1's segment on the graph route: K10 and K11 once a replayed
    # sweep, beside K8 v2 and its tail; bit for bit the host loop's
    cfg, problem, state = _graph_toy(dev, "legacy_v1", **kw)
    problem = problem._replace(init_flow=torch.stack(
        [torch.ones_like(problem.I1), torch.zeros_like(problem.I1)], -1))
    h, _ = _counted(pg.SegmentRunner(cfg, (24, 40), _route="host"), problem, state, 20)
    seg = pg.make_segment_runner(cfg, (24, 40))
    g, got = _counted(seg, problem, state, 20)
    assert seg.route == "graph" and _identical(g, h)
    assert got == [0, 0, 0, 0, 0, 0, 0, 20, 0, 20, 20, 20, 0, 0, 0, 0, 0]



# ---- the autodiff estimator's kernels K13-K15 ----------------------------------------

def _autodiff_state(g, L, M, N, probe):
    """(muu, muv, su, sv, pn, rou) float64: sigma = 0.05 with means over the
    flow range, the init's wide sigmas, means on the range's integer bounds
    (queries on the frame's clamp), or |rho| at the clamp."""
    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)

    site, edge = (L, M, N), (2, 2, L, M, N)
    mu = [u(-2, 2, site), u(-2, 2, site)]
    sg = [torch.full(site, 0.05, dtype=torch.float64)] * 2
    pn, rou = u(-0.9, 0.9, site), u(-0.9, 0.9, edge)
    if probe == "init":
        sg = [u(4, 5, site), u(4, 5, site)]
        pn, rou = torch.zeros(site, dtype=torch.float64), torch.zeros(edge, dtype=torch.float64)
    elif probe == "bounds":
        mu = [torch.where(u(0, 1, site) < 0.5, -2.0, 2.0).double() for _ in range(2)]
    elif probe == "clamp":
        sg = [u(0.01, 3, site), u(0.01, 3, site)]
        pn = 0.99999 * torch.where(u(0, 1, site) < 0.5, -1.0, 1.0).double()
        rou = _clamp_rho(g, L, M, N)
    return (*mu, *sg, pn, rou)


def _autodiff_calls(name, st, frames, dtype, dev):
    """(kernel, plain version, arguments) of K13, K14 or K15 on ``st``."""
    site = [x.to(dev, dtype).contiguous() for x in st[:5]]
    mu, sg = torch.stack(site[:2]), torch.stack(site[2:4])
    rou = st[5].to(dev, dtype).contiguous()
    if name == "K13":
        I1, VV = (x.to(dev, dtype) for x in frames)
        return (autodiff_gq.node_chain_gq_cuda, autodiff_gq.node_chain_gq_torch,
                (I1, VV, *site, 9, 1.0, 1e-6))
    if name == "K14":
        u2e, o2e = edge_reduced_gq.neighbour_stacks(mu, sg)
        return (autodiff_gq.edge_chain_gq_cuda, autodiff_gq.edge_chain_gq_torch,
                (mu, sg, u2e, o2e, rou, 9, 5.0, 1e-6))
    return (autodiff_gq.edge_diff_adjoint_cuda, autodiff_gq.edge_diff_adjoint_torch,
            (mu, sg, rou, 21, 5.0, 1e-6))


def _autodiff_frames(M, N):
    from gqmap_tpu_torch.ops.interp import pad_cubic

    r = np.random.default_rng(M + N)
    I1 = torch.as_tensor(r.uniform(0, 255, (M, N)))
    return I1, pad_cubic(torch.roll(I1, 1, 1) + torch.as_tensor(r.normal(0, 5, (M, N))))


# K13, K14 and K15 in each variant
AUTODIFF_CASES = [("K13", "v1"), ("K13", "v2"), ("K14", "v1"), ("K14", "v2"), ("K15", "v1"),
                  ("K15", "v2")]


def _variant(variant):
    return {} if variant is None else dict(variant=variant)


@pytest.mark.parametrize("probe", ["sigma 0.05", "init", "bounds", "clamp"])
@pytest.mark.parametrize("name, variant", AUTODIFF_CASES)
def test_autodiff_kernels_match_plain(dev, name, variant, probe):
    # float64 within 1e-10 of each output's largest magnitude; float32 against
    # the f64 golden: the kernel's error at most twice the plain version's
    g = torch.Generator().manual_seed(len(probe))
    L, M, N = 3, 47, 57
    st = _autodiff_state(g, L, M, N, probe)
    frames = _autodiff_frames(M, N)
    gold = None
    for dtype in (torch.float64, torch.float32):
        kern, plain, args = _autodiff_calls(name, st, frames, dtype, dev)
        n = kern.launches
        got, want = kern(*args, **_variant(variant)), plain(*args)
        assert kern.launches == n + 1
        if dtype == torch.float64:
            gold = want
            for k, (a, b) in enumerate(zip(got, want)):
                _close(a, b, dtype, f"{name} output {k}")
        else:
            for k, (a, p, w) in enumerate(zip(got, want, gold)):
                ek, ep = float((a.double() - w).abs().max()), float((p.double() - w).abs().max())
                assert ek <= 2.0 * ep + 1e-6 * float(w.abs().max()), (name, k, ek, ep)


@pytest.mark.parametrize("name, variant", AUTODIFF_CASES)
def test_autodiff_kernels_nan_and_shard_block(dev, name, variant):
    # NaN inputs: NaN exactly where the plain version's is, every other element
    # the NaN-free call's bit for bit; a shard's block (K13 at its pixel origin,
    # K15 with its halo) gives the whole lattice's sums there bit for bit
    g = torch.Generator().manual_seed(11)
    L, M, N = 2, 40, 52
    st = list(_autodiff_state(g, L, M, N, "sigma 0.05"))
    frames = _autodiff_frames(M, N)
    vkw = _variant(variant)
    for dtype in (torch.float64, torch.float32):
        kern, plain, args = _autodiff_calls(name, st, frames, dtype, dev)
        clean = kern(*args, **vkw)
        bad = [x.clone() for x in st]
        bad[0][1, 7, 9], bad[4][0, M - 1, N - 1], bad[5][1, 0, 1, 5, 5] = (float("nan"),) * 3
        kern, plain, bargs = _autodiff_calls(name, bad, frames, dtype, dev)
        got, want = kern(*bargs, **vkw), plain(*bargs)
        for a, w, c in zip(got, want, clean):
            nan = torch.isnan(w)
            assert bool(nan.any()) and torch.equal(torch.isnan(a), nan)
            assert torch.equal(a[~nan], c[~nan])
        r0, c0, m, n = 9, 13, 17, 29
        if name == "K13":
            blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
            part = kern(*args[:2], *[x[blk].contiguous() for x in args[2:7]], *args[7:],
                        origin=(r0, c0), local_image_shape=(m, n), **vkw)
        elif name == "K14":
            blk = (Ellipsis, slice(r0, r0 + m), slice(c0, c0 + n))
            part = kern(*[x[blk].contiguous() for x in args[:5]], *args[5:], **vkw)
        else:
            blk = (Ellipsis, slice(r0, r0 + m), slice(c0, c0 + n))
            ms = torch.stack(args[:2])
            halo = (ms[..., r0 + m:r0 + m + 1, c0:c0 + n].contiguous(),
                    ms[..., r0:r0 + m, c0 + n:c0 + n + 1].contiguous())
            part = kern(*[x[blk].contiguous() for x in args[:3]], *args[3:], halo=halo)
        assert all(torch.equal(a, c[blk]) for a, c in zip(part, clean))


def _same_bits(got, want):
    """Bit for bit, NaN where NaN."""
    for a, b in zip(got, want):
        nan = torch.isnan(b)
        if not (torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])):
            return False
    return True


@pytest.mark.parametrize("probe", ["sigma 0.05", "init", "bounds", "clamp", "nan", "inf",
                                   "tiny"])
@pytest.mark.parametrize("name", ["K13", "K14", "K15"])
def test_autodiff_v2_is_v1_bit_for_bit(dev, name, probe):
    # v2 keeps v1's arithmetic, lanes and summation order: the same sums, bit
    # for bit, in each instance (K13 and K14: K = 9 compiled and generic, K =
    # 5; K15: K1 = 21 and 25 compiled and generic, K1 = 13, and with a halo),
    # in both types; K13 v2's L1 route (window_bytes = 0) gives its shared
    # route's sums and counts every CTA and site; an infinite input (root()
    # gives NaN at +inf) and quotients below the fast division's range
    # ("tiny": K14's and K15's neighbours 1e-25 apart at sigma 1e-27, K13 at
    # eps = 0) take v1's sums
    g = torch.Generator().manual_seed(len(probe) + 3)
    L, M, N = 3, 47, 57
    st = list(_autodiff_state(g, L, M, N, probe if probe not in ("nan", "inf", "tiny")
                              else "sigma 0.05"))
    I1, VV = _autodiff_frames(M, N)
    if probe == "nan":
        st[0][1, 7, 9], st[4][0, M - 1, N - 1], st[5][1, 0, 1, 5, 5] = (float("nan"),) * 3
    if probe == "inf":
        I1 = I1.clone()
        I1[5, 6], st[0][1, 7, 9], st[3][0, 3, 3] = (float("inf"),) * 3
    if probe == "tiny" and name in ("K14", "K15"):
        for k in (0, 1):
            st[k] = torch.round(st[k] * 4) / 4 + 1e-25 * torch.randint(-1, 2, st[k].shape,
                                                                       generator=g)
        st[2], st[3] = (torch.full_like(st[2], 1e-27),) * 2
    at = {"K13": 7, "K14": 5, "K15": 3}[name]  # the rule's K among the arguments
    rules = (21, 25, 13) if name == "K15" else (9, 5)
    for dtype in (torch.float64, torch.float32):
        kern, _, args = _autodiff_calls(name, st, (I1, VV), dtype, dev)
        if probe == "tiny" and name == "K13":
            args = (*args[:9], 0.0)
        for K in rules:
            a = (*args[:at], K, *args[at + 1:])
            v1 = kern(*a, variant="v1")
            for generic in (False, True):
                assert _same_bits(kern(*a, variant="v2", generic=generic), v1), (dtype, K, generic)
            if name == "K15":  # a shard's block with its halo, both variants
                r0, c0, m, n = 9, 13, 17, 29
                blk = (Ellipsis, slice(r0, r0 + m), slice(c0, c0 + n))
                ms = torch.stack(a[:2])
                halo = (ms[..., r0 + m:r0 + m + 1, c0:c0 + n].contiguous(),
                        ms[..., r0:r0 + m, c0 + n:c0 + n + 1].contiguous())
                part = [x[blk].contiguous() for x in a[:3]]
                h1 = kern(*part, *a[3:], halo=halo, variant="v1")
                assert _same_bits(kern(*part, *a[3:], halo=halo, variant="v2"), h1), (dtype, K)
            if name == "K13":
                cnt = torch.zeros(2, dtype=torch.int64, device=dev)
                every = torch.zeros(2, dtype=torch.int64, device=dev)
                shared = kern(*a, l1_counts=cnt)
                assert _same_bits(kern(*a, window_bytes=0, l1_counts=every), shared)
                assert every.tolist() == [node_gq.v2_ctas((L, M, N), 1), L * M * N]
                assert 0 <= int(cnt[1]) <= L * M * N


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k15_v2_past_its_32_bit_instance_is_v1_bit_for_bit(dev, dtype):
    # 4100 x 4100 sites a plane (2^24 and more): K15 v2 runs its instance
    # with 64-bit offsets and the row by an integer division, v1's outputs
    # bit for bit
    g = torch.Generator().manual_seed(21)
    shape = (2, 1, 4100, 4100)
    mu = (torch.rand(shape, generator=g) * 4 - 2).to(dev, dtype)
    sg = (0.05 + torch.rand(shape, generator=g)).to(dev, dtype)
    rou = (torch.rand((2,) + shape, generator=g) * 1.8 - 0.9).to(dev, dtype)
    args = (mu, sg, rou, 21, 5.0, 1e-6)
    v1 = autodiff_gq.edge_diff_adjoint_cuda(*args, variant="v1")
    assert _same_bits(autodiff_gq.edge_diff_adjoint_cuda(*args, variant="v2"), v1)


@pytest.mark.parametrize("variant", autodiff_gq.VARIANTS)
@pytest.mark.parametrize("preset, want", [
    ("tpu_fast", dict(K1=1, K15=1)),
    ("full_mixture", dict(K13=1, K14=1)),
    ("legacy_v2", dict(K6=1, K14=1)),
])
def test_autodiff_graph_segment_launches_its_kernels(dev, preset, want, variant, monkeypatch):
    # the three autodiff paths' graph segments: each sweep's kernels once a
    # replay, its backward captured with it; node_kernel = edge_kernel =
    # "torch" (torch.autograd of the plain expectation) launches none, and a
    # sweep through the kernels is as close to the f64 golden as through it;
    # K13 and K14 in each variant
    monkeypatch.setattr(autodiff_gq, "_DEFAULT_VARIANT", variant)
    names = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9 v1", "K9", "K10", "K11", "K12",
             "K13", "K14", "K15", "K16")
    kw = dict(gradient_estimator="autodiff", corr_tor=0.99)
    cfg, problem, state = _graph_toy(dev, preset, **kw)
    seg = pg.make_segment_runner(cfg, (24, 40))
    res, counts = _counted(seg, problem, state, 20)
    assert seg.route == "graph" and res[1] == 20 and bool(torch.isfinite(res[2][:20]).all())
    assert counts == [20 * want.get(k, 0) for k in names]
    plain = dataclasses.replace(cfg, node_kernel="torch", edge_kernel="torch")
    pres, pcounts = _counted(pg.make_segment_runner(plain, (24, 40)), problem, state, 3)
    assert pcounts == [0] * len(names)
    c64, p64, _ = _graph_toy(dev, preset, dtype="float64", node_kernel="torch",
                             edge_kernel="torch", **kw)
    s64 = pg.GQState(*(x.double() if x.is_floating_point() else x for x in state))
    gold = pg.make_sweep(c64, (24, 40))(p64, s64)[0]
    one = pg.make_sweep(cfg, (24, 40))(problem, state)[0]
    ref = pg.make_sweep(plain, (24, 40))(problem, state)[0]
    for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
        ek = float((getattr(one, f).double() - getattr(gold, f)).abs().max())
        ep = float((getattr(ref, f).double() - getattr(gold, f)).abs().max())
        assert ek <= 2.0 * ep + 1e-6, (f, ek, ep)



# ---- K16 and K13 at patch 4: the autodiff estimator's windowed and super-lattice
# bicubic node terms (chain_block_kernel in csrc/node_gq.cu) -----------------------

# name: (window radius rg, 0 for K13 at patch 4; K; lattice (L, M, N))
CHAIN_BLOCK_CASES = {"K16 rg=1": (1, 9, (3, 47, 57)), "K16 rg=2": (2, 9, (3, 47, 57)),
                     "K16 rg=3": (3, 5, (2, 33, 41)), "K16 rg=4": (4, 9, (1, 33, 41)),
                     "K13 patch 4": (0, 11, (3, 12, 14))}


def _chain_block_calls(case, st, frames, dtype, dev):
    """(kernel, plain version, arguments, keywords) of K16 or K13 at patch 4."""
    rg, K, _ = CHAIN_BLOCK_CASES[case]
    site = [x.to(dev, dtype).contiguous() for x in st[:5]]
    I1, VV = (x.to(dev, dtype) for x in frames)
    if rg:
        return (autodiff_gq.node_window_chain_gq_cuda, autodiff_gq.node_window_chain_gq_torch,
                (I1, VV, *site, K, 1.0, 1e-6, rg), {})
    return (autodiff_gq.node_chain_gq_cuda, autodiff_gq.node_chain_gq_torch,
            (I1, VV, *site, K, 1.0, 1e-6), dict(patch=4))


def _chain_block_inputs(case, probe, seed=0):
    rg, _, (L, M, N) = CHAIN_BLOCK_CASES[case]
    g = torch.Generator().manual_seed(len(probe) + 7 * rg + seed)
    P = 1 if rg else 4
    return list(_autodiff_state(g, L, M, N, probe)), _autodiff_frames(M * P, N * P)


@pytest.mark.parametrize("probe", ["sigma 0.05", "init", "bounds", "clamp"])
@pytest.mark.parametrize("case", list(CHAIN_BLOCK_CASES))
def test_chain_block_kernels_match_plain(dev, case, probe):
    # float64 within 1e-10 of each output's largest magnitude; float32 against
    # the f64 golden: the kernel's error at most twice the plain version's
    # ("bounds": queries on the frame's clamp, JAX's half slope there)
    st, frames = _chain_block_inputs(case, probe)
    gold = None
    for dtype in (torch.float64, torch.float32):
        kern, plain, args, kw = _chain_block_calls(case, st, frames, dtype, dev)
        n = kern.launches
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        assert kern.launches == n + 1
        if dtype == torch.float64:
            gold = want
            for k, (a, b) in enumerate(zip(got, want)):
                _close(a, b, dtype, f"{case} output {k}")
        else:
            for k, (a, p, w) in enumerate(zip(got, want, gold)):
                ek, ep = float((a.double() - w).abs().max()), float((p.double() - w).abs().max())
                assert ek <= 2.0 * ep + 1e-6 * float(w.abs().max()), (case, k, ek, ep)


@pytest.mark.parametrize("case", list(CHAIN_BLOCK_CASES))
def test_chain_block_kernels_routes_nan_inf_and_shard_block(dev, case):
    # every route gives the same bits: the window as shifted copies (the
    # default), as one copy (a budget the copies do not fit), through L1 (a
    # budget of 0: every CTA and site counted) and the runtime-K instance;
    # NaN inputs: NaN exactly where the plain version's is, every other site
    # the NaN-free call's bit for bit; infinite inputs: non-finite where the
    # plain version's are; a shard's block (at its pixel origin) the whole
    # lattice's sums there, bit for bit
    rg, K, (L, M, N) = CHAIN_BLOCK_CASES[case]
    P = 1 if rg else 4
    st, frames = _chain_block_inputs(case, "sigma 0.05", seed=1)
    for dtype in (torch.float64, torch.float32):
        kern, plain, args, kw = _chain_block_calls(case, st, frames, dtype, dev)
        clean = kern(*args, **kw)
        cnt = torch.zeros(2, dtype=torch.int64, device=dev)
        every = torch.zeros(2, dtype=torch.int64, device=dev)
        one_copy = torch.zeros(2, dtype=torch.int64, device=dev)
        assert _same_bits(kern(*args, **kw, l1_counts=cnt), clean)
        assert _same_bits(kern(*args, **kw, window_bytes=0, l1_counts=every), clean)
        assert every.tolist() == [autodiff_gq.chain_ctas((L, M, N), rg), L * M * N]
        assert _same_bits(kern(*args, **kw, window_bytes=6 * 1024, l1_counts=one_copy), clean)
        assert _same_bits(kern(*args, **kw, generic=True), clean)
        bad = [x.clone() for x in st]
        bad[0][0, 7, 9], bad[4][L - 1, M - 1, N - 1], bad[2][0, 3, 3] = (float("nan"),) * 3
        _, _, bargs, _ = _chain_block_calls(case, bad, frames, dtype, dev)
        got, want = kern(*bargs, **kw), plain(*bargs, **kw)
        for a, w, c in zip(got, want, clean):
            nan = torch.isnan(w)
            assert bool(nan.any()) and torch.equal(torch.isnan(a), nan)
            assert torch.equal(a[~nan], c[~nan])
        inf = [x.clone() for x in st]
        inf[1][0, 5, 6], inf[3][L - 1, 2, 3] = float("inf"), float("inf")
        I1 = frames[0].clone()
        I1[9, 11] = float("inf")
        _, _, iargs, _ = _chain_block_calls(case, inf, (I1, frames[1]), dtype, dev)
        got, want = kern(*iargs, **kw), plain(*iargs, **kw)
        for a, w in zip(got, want):
            assert torch.equal(torch.isfinite(a), torch.isfinite(w))
        r0, c0, m, n = (5, 7, 17, 23) if rg else (3, 4, 6, 7)
        blk = (slice(None), slice(r0, r0 + m), slice(c0, c0 + n))
        part = kern(*args[:2], *[x[blk].contiguous() for x in args[2:7]], *args[7:], **kw,
                    origin=(r0 * P, c0 * P), local_image_shape=(m * P, n * P))
        assert all(torch.equal(a, c[blk]) for a, c in zip(part, clean))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_block_instances_keep_nothing_in_local_memory(dev, dtype):
    # K16 at every radius (K = 9's instance and the runtime-K one) and K13 at
    # patch 4 (K = 11's and the runtime-K one): no spill to local memory
    for rg in (0, 1, 2, 3, 4):
        K = 11 if rg == 0 else 9
        for generic in (False, True):
            occ = autodiff_gq.occupancy(K, rg, dtype, generic=generic)
            assert occ["local_bytes"] == 0 and occ["ctas_per_sm"] >= 1, (rg, generic, occ)


@pytest.mark.parametrize("preset, override, want", [
    ("full_mixture", dict(window_rg=2), dict(K14=1, K16=1)),
    ("legacy_v2", dict(data_term="bicubic"), dict(K14=1, K16=1)),
    ("super_entropy", {}, dict(K13=1, K14=1)),
])
def test_autodiff_window_and_super_segments_launch_their_kernels(dev, preset, override, want):
    # the windowed and the super lattice's bicubic term under autodiff: K16 or
    # K13 at patch 4 and K14 once a replayed sweep; a sweep through them as
    # close to the f64 golden (the plain route in float64) as the plain route
    names = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9 v1", "K9", "K10", "K11", "K12",
             "K13", "K14", "K15", "K16")
    kw = dict(gradient_estimator="autodiff", corr_tor=0.99, **override)
    shape = (32, 40) if preset == "super_entropy" else (24, 40)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, shape)
    fr = FlowRange(-2, 2, -2, 2)

    def made(**more):
        cfg = getattr(GQMAPConfig, preset)(its=60, eval_every=30, **kw, **more)
        problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, dev)
        return cfg, problem, pg.init_state(cfg, fr, shape, device=dev)

    cfg, problem, state = made()
    state = state._replace(sigmau=torch.full_like(state.sigmau, 0.3),
                           sigmav=torch.full_like(state.sigmav, 0.4))
    seg = pg.make_segment_runner(cfg, shape)
    res, counts = _counted(seg, problem, state, 20)
    assert seg.route == "graph" and res[1] == 20 and bool(torch.isfinite(res[2][:20]).all())
    assert counts == [20 * want.get(k, 0) for k in names]
    plain = dict(node_kernel="torch", edge_kernel="torch")
    c64, p64, _ = made(dtype="float64", **plain)
    s64 = pg.GQState(*(x.double() if x.is_floating_point() else x for x in state))
    gold = pg.make_sweep(c64, shape)(p64, s64)[0]
    one = pg.make_sweep(cfg, shape)(problem, state)[0]
    ref = pg.make_sweep(dataclasses.replace(cfg, **plain), shape)(problem, state)[0]
    for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
        ek = float((getattr(one, f).double() - getattr(gold, f)).abs().max())
        ep = float((getattr(ref, f).double() - getattr(gold, f)).abs().max())
        assert ek <= 2.0 * ep + 1e-6, (f, ek, ep)


def test_chain_block_kernels_past_their_limits(dev):
    # K16 past radius 4 and K13 at patch 2: "auto" sweeps on the plain
    # version with neither kernel launched, "cuda" is refused naming the limit
    fr = FlowRange(-2, 2, -2, 2)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (16, 24))
    k13, k16 = autodiff_gq.node_chain_gq_cuda, autodiff_gq.node_window_chain_gq_cuda
    for override in (dict(window_rg=5), dict(patch=2)):
        cfg = GQMAPConfig.full_mixture(gradient_estimator="autodiff", L=2, **override)
        problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, dev)
        state = pg.init_state(cfg, fr, (16, 24), device=dev)
        n = (k13.launches, k16.launches)
        st, aux = pg.make_sweep(cfg, (16, 24))(problem, state)
        torch.cuda.synchronize()
        assert (k13.launches, k16.launches) == n and bool(torch.isfinite(aux.energy))
        with pytest.raises(ValueError, match="does not take this configuration's shape"):
            pg.make_sweep(dataclasses.replace(cfg, node_kernel="cuda"), (16, 24))


# ---- D7: every configuration the JAX package runs runs on the card -------------------

@pytest.mark.parametrize("preset", ["tpu_fast", "tpu_fast_super"])
@pytest.mark.parametrize("estimator", ["stein", "autodiff"])
def test_five_components_sweep_through_k1_in_groups(dev, preset, estimator):
    # L = 5 runs K1 as two groups (3 + 2 components), two launches a sweep,
    # each group reading its slice of the phase stack in place: one sweep
    # from the init on "auto" and on "cuda", as close to the f64 golden (the
    # plain route in float64) as the plain route in float32 is, by the ratio
    # rule of tests/test_f32_conditioning.py; the groups' sums are the plain
    # full sums' within the float32 tolerance
    kw = dict(L=5, gradient_estimator=estimator, corr_tor=0.99)
    shape = (32, 40) if preset == "tpu_fast_super" else (24, 40)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, shape)
    fr = FlowRange(-2, 2, -2, 2)
    plain = dict(node_kernel="torch", edge_kernel="torch")

    def sweep(dtype="float32", **routes):
        cfg = getattr(GQMAPConfig, preset)(cheb_p=16, cheb_q=8, dtype=dtype, **kw, **routes)
        problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, dev)
        state = pg.init_state(cfg, fr, shape, device=dev)
        return pg.make_sweep(cfg, shape)(problem, state)[0], problem, state

    k1 = cosine_gq.cos_mode_sums_cuda
    gold = sweep("float64", **plain)[0]
    ref = sweep(**plain)[0]
    for route in ("auto", "cuda"):
        n = k1.launches
        got, problem, state = sweep(node_kernel=route, edge_kernel=route)
        torch.cuda.synchronize()
        assert k1.launches - n == len(cosine_gq.component_groups(5)) == 2
        for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
            assert bool(torch.isfinite(getattr(got, f)).all()), f
            ek = float((getattr(got, f).double() - getattr(gold, f)).abs().max())
            ep = float((getattr(ref, f).double() - getattr(gold, f)).abs().max())
            assert ek <= 2.0 * ep + 1e-6, (route, f, ek, ep)
    sites = (state.muu, state.muv, state.sigmau, state.sigmav, state.pn)
    for g, w in zip(cosine_gq.cos_mode_sums_cuda(problem.cheb, *sites),
                    cosine_gq.cos_mode_sums_torch(problem.cheb, *sites)):
        _close(g, w, torch.float32, "K1 in groups")


def test_a_rule_past_every_kernels_limit_sweeps_on_auto(dev):
    # full_mixture at K = 65: past K4's 64 points an axis and K3's shared
    # memory, so "auto" runs both plain versions (no launch of either) and
    # does not raise; "cuda" is refused, naming the limit
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (12, 16))
    fr = FlowRange(-2, 2, -2, 2)
    cfg = GQMAPConfig.full_mixture(K=65, L=2, quad_chunk=700)
    problem = pg.make_problem(cfg, I1, np.roll(I1, 1, axis=1), fr, dev)
    state = pg.init_state(cfg, fr, (12, 16), device=dev)
    n = (node_gq.node_gq_cuda.launches, edge_gq.edge_gq_cuda.launches)
    st, aux = pg.make_sweep(cfg, (12, 16))(problem, state)
    torch.cuda.synchronize()
    assert (node_gq.node_gq_cuda.launches, edge_gq.edge_gq_cuda.launches) == n
    assert all(bool(torch.isfinite(x).all()) for x in st if x.is_floating_point())
    assert bool(torch.isfinite(aux.energy))
    for field in ("node_kernel", "edge_kernel"):
        with pytest.raises(ValueError, match="does not take this configuration's shape"):
            pg.make_sweep(dataclasses.replace(cfg, **{field: "cuda"}), (12, 16))
