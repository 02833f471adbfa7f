"""Kernel K2's module: the port's plain reduced-edge gradients against the
JAX Pallas kernel (interpret mode) and the JAX ops path, in float64 at 1e-10.
The port reads endpoint 2 from ``mu``/``sg`` itself; the JAX side is given
the rolled neighbour stacks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_fields_close, t
from gqmap_tpu.kernels.edge_reduced_gq import edge_reduced_grads_pallas
from gqmap_tpu.ops.gq import EDGE, finalize, gq_accumulate_diff
from gqmap_tpu.ops.potentials import make_edge_pot_diff
from gqmap_tpu.ops.quadrature import build_table_1d
from gqmap_tpu_torch.kernels import edge_reduced_gq


def _edge_inputs(L=3, M=17, N=23, seed=1):
    # ragged M: exercises the TPU kernel's out-of-bounds row-block masking
    r = np.random.default_rng(seed)
    mu = r.normal(size=(2, L, M, N))
    sg = r.uniform(0.5, 3, (2, L, M, N))
    u2e = np.stack([np.roll(mu, -1, -2), np.roll(mu, -1, -1)])
    o2e = np.stack([np.roll(sg, -1, -2), np.roll(sg, -1, -1)])
    rou = r.uniform(-0.9, 0.9, (2, 2, L, M, N))
    alpha = np.array([0.5, 0.3, 0.2][:L])
    return mu, sg, u2e, o2e, rou, alpha


@pytest.mark.parametrize("T", [0.0, 0.17])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_plain_edge_grads_match_jax(ref, T):
    mu, sg, u2e, o2e, rou, alpha = _edge_inputs()
    k1 = 13
    j = dict(zip(("mu", "sg", "u2e", "o2e", "rou", "alpha"),
                 map(jnp.asarray, (mu, sg, u2e, o2e, rou, alpha))))
    if ref == "xla":
        raw = gq_accumulate_diff(make_edge_pot_diff(5.0, 1e-6), j["mu"][None], j["u2e"],
                                 j["sg"][None], j["o2e"], j["rou"],
                                 build_table_1d(k1, dtype=np.float64))
        want = finalize(raw, j["alpha"].reshape(3, 1, 1), j["sg"][None], j["o2e"], j["rou"],
                        T, EDGE)
    else:
        want = edge_reduced_grads_pallas(j["mu"], j["sg"], j["u2e"], j["o2e"], j["rou"],
                                         j["alpha"], jnp.asarray(T), k1, 5.0, 1e-6, EDGE,
                                         rows=8, interpret=True)
    got = edge_reduced_gq.edge_reduced_grads_torch(
        *map(t, (mu, sg, rou, alpha)), torch.tensor(T, dtype=torch.float64),
        k1, 5.0, 1e-6, EDGE)
    assert_fields_close(got, want, 1e-10, 1e-12)


@pytest.mark.parametrize("M, N", [(17, 23), (1, 5), (6, 1)])
def test_neighbour_stacks_match_jax(M, N):
    # the stacks of gqmap_tpu/models/gqmap.py:497-498 (single device: jnp.roll)
    mu, sg = _edge_inputs(L=2, M=M, N=N, seed=3)[:2]
    want = [jnp.stack([jnp.roll(a, -1, -2), jnp.roll(a, -1, -1)]) for a in map(jnp.asarray,
                                                                               (mu, sg))]
    got = edge_reduced_gq.neighbour_stacks(t(mu), t(sg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    mu, sg, _, _, rou, alpha = map(t, _edge_inputs(L=2, M=4, N=5, seed=2))
    T = torch.tensor(0.1, dtype=torch.float64)
    args = (mu, sg, rou, alpha, T, 21, 5.0, 1e-6, EDGE)
    got = edge_reduced_gq.edge_reduced_grads(*args)
    want = edge_reduced_gq.edge_reduced_grads_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert edge_reduced_gq.edge_reduced_grads_cuda.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        edge_reduced_gq.edge_reduced_grads_cuda(*args)
    assert edge_reduced_gq.edge_reduced_grads_cuda.launches == 0
