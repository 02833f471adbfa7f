"""Kernel K3's module: the port's plain tensor-rule edge sums against the JAX
Pallas kernel (interpret mode) and the JAX ops path, in float64 at 1e-10 of
each sum's largest magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, t
from gqmap_tpu.kernels.edge_gq import edge_gq_pallas
from gqmap_tpu.kernels.edge_gq import pack_table as jax_pack_table
from gqmap_tpu.ops.gq import gq_accumulate
from gqmap_tpu.ops.potentials import make_edge_pot
from gqmap_tpu.ops.quadrature import build_table
from gqmap_tpu_torch.kernels import edge_gq

RHO = {"warm": 0.9, "clamp": 0.99999}  # |rho| bound (warm) or value (clamp, random sign)


def _edge_inputs(rho, L=3, M=8, N=16, seed=1):
    r = np.random.default_rng(seed)
    mu = r.normal(size=(2, L, M, N)) * 3
    sg = r.uniform(0.01, 3, (2, L, M, N))
    u2e = np.stack([np.roll(mu, -1, -2), np.roll(mu, -1, -1)])
    o2e = np.stack([np.roll(sg, -1, -2), np.roll(sg, -1, -1)])
    if rho == "warm":
        rou = r.uniform(-RHO[rho], RHO[rho], (2, 2, L, M, N))
    else:
        rou = RHO[rho] * np.where(r.uniform(size=(2, 2, L, M, N)) < 0.5, -1.0, 1.0)
    return mu, sg, u2e, o2e, rou


@pytest.mark.parametrize("K", [5, 9])
@pytest.mark.parametrize("rho", list(RHO))
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_plain_edge_sums_match_jax(ref, rho, K):
    mu, sg, u2e, o2e, rou = _edge_inputs(rho)
    j = [jnp.asarray(a) for a in (mu, sg, u2e, o2e, rou)]
    if ref == "xla":
        want = gq_accumulate(make_edge_pot(5.0, 1e-6), j[0][None], j[2], j[1][None], j[3], j[4],
                             build_table(K, 0, np.float64))
    else:
        want = edge_gq_pallas(j[0][None], j[2], j[1][None], j[3], j[4], K, 5.0, 1e-6,
                              rows=8, interpret=True)
    got = edge_gq.edge_gq_torch(*map(t, (mu, sg, u2e, o2e, rou)), K, 5.0, 1e-6)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert getattr(got, name).shape == w.shape == (2, 2, 3, 8, 16)
        assert_close(getattr(got, name), w, 0, 1e-10 * np.abs(w).max(), name)


@pytest.mark.parametrize("K", [3, 9, 17])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_table_matches_jax(K, dtype):
    # the kernel's paired rule is the JAX kernel's (6, K^2) table folded into
    # pairs of a point and its mirror image, then the centre point
    got = edge_gq.paired_rule(K, dtype)
    P = K * K // 2
    assert got.dtype == dtype and got.shape == (8 * P + 1,)
    xi, xj, w, wxi, wxj, wxixj, wx2a, wx2m = got[:8 * P].reshape(8, P)
    tab = jax_pack_table(K, np.float64)
    k = edge_gq.pair_order(K)
    mirror = K * K - 1 - k
    # every point but the centre, once, in a pair with its mirror
    assert sorted(np.concatenate([k, mirror]).tolist()) == sorted(set(range(K * K)) - {P})
    tol = 1e-6 if dtype == np.float32 else 1e-14
    for a, b in ((xi, tab[0, k]), (xj, tab[1, k]), (xi, -tab[0, mirror]), (xj, -tab[1, mirror]),
                 (w, tab[2, k]), (w, tab[2, mirror]), (wxi, tab[2, k] * tab[0, k]),
                 (wxj, tab[2, k] * tab[1, k]), (wxixj, tab[2, k] * tab[3, k]),
                 (wx2a, tab[2, k] * (tab[4, k] - 1)), (wx2m, tab[2, k] * tab[5, k]),
                 (got[8 * P:], tab[2, P:P + 1])):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("rho", list(RHO))
def test_plain_edge_sums_at_k17_match_pallas_interpret(rho):
    # blockmatch_v2's K = 17 (289 points, the kernel's generic instance) on
    # its L = 1 lattice
    mu, sg, u2e, o2e, rou = _edge_inputs(rho, L=1, M=4, N=6, seed=17)
    j = [jnp.asarray(a) for a in (mu, sg, u2e, o2e, rou)]
    want = edge_gq_pallas(j[0][None], j[2], j[1][None], j[3], j[4], 17, 1.7, 1e-4, rows=8,
                          interpret=True)
    got = edge_gq.edge_gq_torch(*map(t, (mu, sg, u2e, o2e, rou)), 17, 1.7, 1e-4)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert getattr(got, name).shape == w.shape == (2, 2, 1, 4, 6)
        assert_close(getattr(got, name), w, 0, 1e-10 * np.abs(w).max(), name)


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    args = (*map(t, _edge_inputs("warm", L=2, M=4, N=5, seed=2)), 5, 5.0, 1e-6)
    got = edge_gq.edge_gq(*args)
    want = edge_gq.edge_gq_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert edge_gq.edge_gq_cuda.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        edge_gq.edge_gq_cuda(*args)
    assert edge_gq.edge_gq_cuda.launches == 0


@pytest.mark.parametrize("K", [5, 9, 11, 17])
def test_pair_order_keeps_sm_partial_sums_small(K):
    # each pair is followed by its transpose partner, whose XI^2 - XJ^2
    # weight is the opposite: the Sm accumulator's partial sums of the
    # weights never exceed one pair's weight
    wx2m = edge_gq.paired_rule(K)[7 * (K * K // 2):8 * (K * K // 2)]
    assert np.abs(np.cumsum(wx2m)).max() <= np.abs(wx2m).max() * (1 + 1e-12)
    assert abs(wx2m.sum()) < 1e-15
