"""Kernel K1's module: the port's cosine data term against the JAX package's.

The plain mode sums (``gqmap_tpu_torch.ops.cosine._mode_sums``, the plain
version of the CUDA kernel) are held to the JAX scan path and to the Pallas
kernel run in interpret mode, in all three of its variants on the JAX
package's own variant inputs, in float64 at 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, assert_fields_close, t
from gqmap_tpu.kernels.cosine_gq import cos_mode_sums_pallas
from gqmap_tpu.ops import cosine as jcos
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops.gq import NODE
from gqmap_tpu_torch.kernels import cosine_gq
from gqmap_tpu_torch.ops import cosine

SUMS = ("E0", "A1", "A2", "Aa", "Ab", "Ax")
# (A, B, M, N, L, a_block) — the ragged case has A % a_block != 0 and
# M % rows != 0 (tests/test_cosine_kernel.py:24-32)
CASES = {"main": (20, 6, 16, 24, 3, 8), "ragged": (13, 5, 12, 16, 2, 4)}
# The JAX package's own inputs for the kernel variants (tests/test_cosine_kernel.py):
# (A, B, M, N, L, a_block, coefficient seed, site seed, sig_hi, o1 shift, p scale)
VARIANT_CASES = {
    "tight": (24, 6, 16, 24, 3, 8, 15, 16, 0.08, 0.0, None),  # tight sigma: recur is taken
    "sigma2": (64, 4, 16, 16, 2, 8, 13, 14, 3.0, 2.0, None),  # sigma + 2: the cutoff truncates
    "wide": (48, 6, 16, 16, 2, 8, 17, 18, 3.0, 2.0, 1.1),     # wide, correlated: recur falls back
}


def _cos_pair(A, B, M, N, seed, box=(-2.0, 3.0, -1.5, 1.0)):
    r = np.random.default_rng(seed)
    coeffs = r.normal(size=(A, B, M, N)) / (1.0 + np.arange(A)[:, None, None, None])
    lo_u, hi_u, lo_v, hi_v = box
    jc = jcos.CosData(coeffs=jnp.asarray(coeffs), lo_u=jnp.asarray(lo_u),
                      hi_u=jnp.asarray(hi_u), lo_v=jnp.asarray(lo_v), hi_v=jnp.asarray(hi_v))
    return jc, cosine.CosData(t(coeffs), lo_u, hi_u, lo_v, hi_v)


def _sites(M, N, L, seed, sig_hi=2.0):
    r = np.random.default_rng(seed)
    return (r.uniform(-1.5, 2.5, (L, M, N)), r.uniform(-1.2, 0.7, (L, M, N)),
            r.uniform(0.05, sig_hi, (L, M, N)), r.uniform(0.05, sig_hi, (L, M, N)),
            r.uniform(-0.9, 0.9, (L, M, N)))


def _scaled_close(got, want, rtol, name):
    # tolerance relative to the sum's scale: the mode sums cancel
    want = np.asarray(want)
    assert_close(got, want, 0, rtol * max(np.abs(want).max(), 1e-300), name)


def test_build_cos_data_matches():
    r = np.random.default_rng(0)
    I1, I2 = r.uniform(0, 255, (10, 13)), r.uniform(0, 255, (10, 13))
    box = (-3.0, 2.0, -1.5, 1.5)
    want = jcos.build_cos_data(jnp.asarray(I1), jinterp.pad_cubic(jnp.asarray(I2)), 1.0,
                               1e-6, box, A=12, B=6)
    got = cosine.build_cos_data(t(I1), t(np.asarray(jinterp.pad_cubic(jnp.asarray(I2)))),
                                1.0, 1e-6, box, A=12, B=6)
    _scaled_close(got.coeffs, want.coeffs, 1e-12, "coeffs")
    assert (got.lo_u, got.hi_u, got.lo_v, got.hi_v) == box


@pytest.mark.parametrize("case", list(CASES))
def test_mode_sums_match_jax_scan(case):
    A, B, M, N, L, a_block = CASES[case]
    jc, pc = _cos_pair(A, B, M, N, seed=7)
    s = _sites(M, N, L, seed=8)
    want, _ = jcos._mode_sums(jc, *map(jnp.asarray, s), a_block, want_grads=True)
    got = cosine._mode_sums(pc, *map(t, s))
    for g, w, name in zip(got, want, SUMS):
        _scaled_close(g, w, 1e-10, name)


def _variant_inputs(case):
    """(A, B, a_block, JAX coefficients, port coefficients, numpy sites) of a case."""
    if case in CASES:
        A, B, M, N, L, a_block = CASES[case]
        jc, pc = _cos_pair(A, B, M, N, seed=9)
        return A, B, a_block, jc, pc, _sites(M, N, L, seed=10, sig_hi=1.5)
    A, B, M, N, L, a_block, cseed, sseed, sig_hi, shift, pscale = VARIANT_CASES[case]
    jc, pc = _cos_pair(A, B, M, N, seed=cseed)
    u1, u2, o1, o2, p = _sites(M, N, L, seed=sseed, sig_hi=sig_hi)
    if pscale is not None:
        p = np.clip(p * pscale, -0.99999, 0.99999)
    return A, B, a_block, jc, pc, (u1, u2, o1 + shift, o2, p)


@pytest.mark.parametrize("case, variant", [
    ("main", "v1"), ("ragged", "v1"), ("ragged", None), ("ragged", "adaptive"),
    ("ragged", "recur"), ("tight", "adaptive"), ("tight", "recur"), ("sigma2", "adaptive"),
    ("sigma2", "recur"), ("wide", "adaptive"), ("wide", "recur")])
def test_mode_sums_match_pallas_interpret(case, variant):
    # the plain version is the full sum; the cutoff (< e^-50) and the
    # recurrence change the kernel's sums only at rounding level
    A, B, a_block, jc, pc, s = _variant_inputs(case)
    want = cos_mode_sums_pallas(jc, *map(jnp.asarray, s), a_block=a_block, rows=8,
                                interpret=True, variant=variant)
    got = cosine._mode_sums(pc, *map(t, s))
    for g, w, name in zip(got, want, SUMS):
        _scaled_close(g, w, 1e-10, name)


def test_cos_node_grads_match():
    jc, pc = _cos_pair(16, 4, 16, 16, seed=11)
    s = _sites(16, 16, 3, seed=12)
    a = np.ones((3, 1, 1)) / 3.0
    want = jcos.cos_node_grads(jc, *map(jnp.asarray, s), jnp.asarray(a), 0.25, NODE)
    got = cosine.cos_node_grads(pc, *map(t, s), t(a), 0.25, NODE)
    for f in want._fields:
        _scaled_close(getattr(got, f), getattr(want, f), 1e-10, f)


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    jc, pc = _cos_pair(8, 4, 5, 6, seed=13)
    s = tuple(map(t, _sites(5, 6, 3, seed=14)))
    before = cosine_gq.cos_mode_sums_cuda.launches
    got = cosine_gq.cos_mode_sums(pc, *s)
    want = cosine_gq.cos_mode_sums_torch(pc, *s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cosine_gq.cos_mode_sums_cuda.launches == before == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        cosine_gq.cos_mode_sums_cuda(pc, *s)
    assert cosine_gq.cos_mode_sums_cuda.launches == 0


def test_finalize_mode_sums_matches():
    jc, pc = _cos_pair(6, 5, 3, 4, seed=15)
    s = _sites(3, 4, 2, seed=16)
    r = np.random.default_rng(17)
    sums = [r.normal(size=(2, 3, 4)) for _ in range(6)]
    a = np.array([0.6, 0.4]).reshape(2, 1, 1)
    u1, _, o1, o2, p = s
    want = jcos._finalize_mode_sums(jc, tuple(map(jnp.asarray, sums)), *map(jnp.asarray, (
        u1, o1, o2, p, a)), 0.1, NODE)
    got = cosine._finalize_mode_sums(pc, tuple(map(t, sums)), *map(t, (u1, o1, o2, p, a)),
                                     0.1, NODE)
    assert_fields_close(got, want, 1e-10, 1e-12)


@pytest.mark.parametrize("variant", [None, "v1", "adaptive", "recur"])
def test_wrapper_runs_plain_sums_on_cpu_for_every_variant(variant):
    _, _, _, _, pc, s = _variant_inputs("sigma2")
    s = tuple(map(t, s))
    before = cosine_gq.cos_mode_sums_cuda.launches
    got = cosine_gq.cos_mode_sums(pc, *s, variant=variant)
    want = cosine._mode_sums(pc, *s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cosine_gq.cos_mode_sums_cuda.launches == before == 0


def test_unknown_variant_raises():
    jc, pc = _cos_pair(8, 4, 5, 6, seed=13)
    s = tuple(map(t, _sites(5, 6, 3, seed=14)))
    for fn in (cosine_gq.cos_mode_sums, cosine_gq.cos_mode_sums_cuda):
        with pytest.raises(ValueError, match="variant"):
            fn(pc, *s, variant="v2")
    assert cosine_gq.cos_mode_sums_cuda.launches == 0


@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, True)])
def test_make_problem_keeps_callers_tf32_flags(flags):
    # build_cos_data turns both TF32 switches off for its DCT products and
    # gives the caller's back afterwards
    from gqmap_tpu_torch import FlowRange, GQMAPConfig
    from gqmap_tpu_torch.models import gqmap as pg

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        r = np.random.default_rng(0)
        I1 = r.uniform(0, 255, (8, 12))
        cfg = GQMAPConfig.tpu_fast(K=3, cheb_p=8, cheb_q=4, dtype="float64")
        p = pg.make_problem(cfg, I1, np.roll(I1, 1, 1), FlowRange(-2, 2, -2, 2), device="cpu")
        assert p.cheb.coeffs.shape == (8, 4, 8, 12)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("L", range(1, 13))
def test_component_groups_cover_the_components_evenly(L):
    # K1 runs more than MAX_L components as the fewest groups of at most MAX_L
    # consecutive ones, sized as evenly as possible, the larger first
    groups = cosine_gq.component_groups(L)
    assert len(groups) == -(-L // cosine_gq.MAX_L)
    assert [l0 for l0, _ in groups] == [sum(n for _, n in groups[:k]) for k in range(len(groups))]
    sizes = [n for _, n in groups]
    assert sum(sizes) == L and max(sizes) <= cosine_gq.MAX_L
    assert sizes == sorted(sizes, reverse=True) and max(sizes) - min(sizes) <= 1
    if L == 5:
        assert groups == [(0, 3), (3, 2)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [5, 7, 9])
def test_grouped_plain_sums_are_one_calls_bit_for_bit(L, dtype):
    # by_groups, the grouping K1's launches take, with the plain sums as each
    # group's sums: every component's six sums are the one call's, bit for
    # bit. (A lattice of 16 x 12 sites: where M N leaves a ragged vector tail,
    # torch's CPU sum over the plain version's leading v-degree axis orders an
    # element's terms by its place in the whole tensor, so a slice's plain
    # sums may round apart from the whole's; that is the plain version's
    # rounding, not the grouping's.)
    M, N = 12, 16
    _, pc = _cos_pair(13, 5, M, N, seed=20 + L)
    pc = pc._replace(coeffs=pc.coeffs.to(dtype))
    s = [t(x).to(dtype) for x in _sites(M, N, L, seed=30 + L)]
    want = cosine_gq.cos_mode_sums_torch(pc, *s)
    calls = []

    def sums(l0, n, part):
        calls.append((l0, n))
        part.copy_(torch.stack(cosine_gq.cos_mode_sums_torch(pc, *(x[l0:l0 + n] for x in s))))

    got = cosine_gq.by_groups(sums, torch.empty((6, L, M, N), dtype=dtype))
    assert calls == cosine_gq.component_groups(L)
    for g, w, name in zip(got, want, SUMS):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("variant", ["v1", "recur"])
def test_grouped_plain_sums_match_pallas_interpret_at_L5(variant):
    # tpu_fast(L=5)'s node term: the JAX kernel takes the five components in
    # one call; the port's K1 takes them as groups of 3 and 2 (here each
    # group's plain sums), within 1e-10 of each sum's scale
    A, B, M, N, L = 20, 6, 16, 24, 5
    jc, pc = _cos_pair(A, B, M, N, seed=21)
    s = _sites(M, N, L, seed=22, sig_hi=1.5)
    want = cos_mode_sums_pallas(jc, *map(jnp.asarray, s), a_block=8, rows=8, interpret=True,
                                variant=variant)
    st = [t(x) for x in s]
    got = cosine_gq.by_groups(
        lambda l0, n, part: part.copy_(torch.stack(
            cosine_gq.cos_mode_sums_torch(pc, *(x[l0:l0 + n] for x in st)))),
        torch.empty((6, L, M, N), dtype=torch.float64))
    for g, w, name in zip(got, want, SUMS):
        _scaled_close(g, w, 1e-10, name)
