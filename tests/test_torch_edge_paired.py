"""The paired-point arithmetic of kernels K3 and K2, transcribed in torch f64.

The CUDA kernels (``csrc/edge_gq.cu``, ``csrc/edge_reduced_gq.cu``) pair each
point of the Gauss-Hermite rule with its mirror image, take the centre node
alone, and regroup the sums (K3: Z1 and Z2 from the two odd moments; K2:
reciprocals in the epilogue and the neighbour read by index). They run only
on the card, so their arithmetic is transcribed here, step for step, from
the rules the kernels are given (``paired_rule``, ``paired_rule_1d``), and
held to the JAX Pallas kernels in interpret mode at 1e-10: an algebra error
shows here before any card run. Odd and even rules, |rho| up to 0.9.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, assert_fields_close, t
from gqmap_tpu.kernels.edge_gq import edge_gq_pallas
from gqmap_tpu.kernels.edge_reduced_gq import edge_reduced_grads_pallas
from gqmap_tpu_torch.kernels.edge_gq import paired_rule
from gqmap_tpu_torch.kernels.edge_reduced_gq import paired_rule_1d
from gqmap_tpu_torch.ops.gq import EDGE, GQGrads, GQRaw

SQRT2 = math.sqrt(2.0)
LAM, EPS = 5.0, 1e-6


def _inputs(L=3, M=8, N=16, seed=4):
    r = np.random.default_rng(seed)
    mu = r.normal(size=(2, L, M, N)) * 3
    sg = r.uniform(0.01, 3, (2, L, M, N))
    rou = r.uniform(-0.9, 0.9, (2, 2, L, M, N))
    u2e = np.stack([np.roll(mu, -1, -2), np.roll(mu, -1, -1)])
    o2e = np.stack([np.roll(sg, -1, -2), np.roll(sg, -1, -1)])
    return mu, sg, u2e, o2e, rou


def k3_paired(mu, sg, u2e, o2e, rou, K, lam, eps):
    """``edge_gq_kernel`` of ``csrc/edge_gq.cu``: one (D, C, L, M, N) element
    per lane, endpoint 1 the state plane ``dc % C`` (broadcast over D)."""
    o1e, o2e = sg[None] * SQRT2, o2e * SQRT2
    delta = mu[None] - u2e
    sp, sm = torch.sqrt(1 + rou), torch.sqrt(1 - rou)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    A, B = o1e * s - o2e * tt, o1e * tt - o2e * s
    rule = paired_rule(K)
    P = K * K // 2
    rows, wc = rule[:8 * P].reshape(8, P), float(rule[8 * P])
    e, sxi, sxj, sxixj, sx2a, sx2m = (torch.zeros_like(delta) for _ in range(6))
    for xi, xj, w, wxi, wxj, wxixj, wx2a, wx2m in rows.T:
        q = A * xi + B * xj
        fp = torch.sqrt(eps + (delta + q) ** 2)
        fm = torch.sqrt(eps + (delta - q) ** 2)
        even, odd = fp + fm, fp - fm
        e += w * even
        sxi += wxi * odd
        sxj += wxj * odd
        sxixj += wxixj * even
        sx2a += wx2a * even
        sx2m += wx2m * even
    if K % 2:
        f = wc * torch.sqrt(eps + delta * delta)
        e += f
        sx2a -= f
    nl = -lam
    return GQRaw(nl * e, nl * (s * sxi + tt * sxj), nl * (tt * sxi + s * sxj), nl * sx2a,
                 nl * sx2m, nl * sxixj)


def k2_paired(mu, sg, rou, alpha, T, k1, lam, eps, entropy_scale):
    """``edge_reduced_kernel`` of ``csrc/edge_reduced_gq.cu``: endpoint 2 read
    by index, ``(m+1) % M`` (direction 0) and ``(n+1) % N`` (direction 1)."""
    C, L, M, N = mu.shape
    down = [m + 1 if m + 1 < M else 0 for m in range(M)]
    right = [n + 1 if n + 1 < N else 0 for n in range(N)]
    o1 = sg[None]
    o2 = torch.stack([sg[:, :, down], sg[:, :, :, right]])
    u2 = torch.stack([mu[:, :, down], mu[:, :, :, right]])
    p = rou
    o1e, o2e = o1 * SQRT2, o2 * SQRT2
    delta = mu[None] - u2
    c = o1e * o1e + o2e * o2e - 2 * p * o1e * o2e
    c = torch.clamp(c, min=torch.finfo(c.dtype).tiny)
    rc = torch.sqrt(c)
    rule = paired_rule_1d(k1)
    P = k1 // 2
    rows, wc = rule[:4 * P].reshape(4, P), float(rule[4 * P])
    h0, h1, h2 = (torch.zeros_like(delta) for _ in range(3))
    for x, w, wx, wq in rows.T:
        sx = rc * x
        gp = torch.sqrt(eps + (delta + sx) ** 2)
        gm = torch.sqrt(eps + (delta - sx) ** 2)
        h0 += w * (gp + gm)
        h1 += wx * (gp - gm)
        h2 += wq * (gp + gm)
    gc = wc * torch.sqrt(eps + delta * delta)
    h0 += gc
    h2 -= 0.5 * gc

    inv_rc = 1 / rc
    nl = -lam * math.sqrt(math.pi)
    h1s = nl * h1 * inv_rc
    h2s = nl * h2 * inv_rc * inv_rc
    Ei = nl * h0
    Z1 = (o1e - p * o2e) * h1s
    Z2 = (p * o1e - o2e) * h1s
    Sa = nl * h2
    sm_w = (o1e * o1e - o2e * o2e) * h2s
    Sxy = (0.5 * p * (o1e * o1e + o2e * o2e) - o1e * o2e) * h2s
    a = alpha.reshape(L, 1, 1)
    cn = entropy_scale * T
    inv_pi = 1 / math.pi
    pr = 1 - p * p
    inv_o1, inv_o2, inv_pr = 1 / o1, 1 / o2, 1 / pr
    da = Ei * inv_pi - cn * (1 + math.log(2 * math.pi) + torch.log(torch.sqrt(pr) * o1 * o2))
    return GQGrads(
        da=da,
        du1=a * (Z1 - p * Z2) * (SQRT2 * inv_o1 * inv_pr) * inv_pi,
        du2=a * (Z2 - p * Z1) * (SQRT2 * inv_o2 * inv_pr) * inv_pi,
        do1=a * ((Sa + sm_w) * inv_pi - cn) * inv_o1,
        do2=a * ((Sa - sm_w) * inv_pi - cn) * inv_o2,
        dp=a * ((2 * Sxy - p * Sa) * inv_pi + cn * p) * inv_pr,
        E=a * da)


@pytest.mark.parametrize("K", [4, 5, 9])
def test_k3_paired_arithmetic_matches_pallas(K):
    mu, sg, u2e, o2e, rou = _inputs()
    j = [jnp.asarray(a) for a in (mu, sg, u2e, o2e, rou)]
    want = edge_gq_pallas(j[0][None], j[2], j[1][None], j[3], j[4], K, LAM, EPS, rows=8,
                          interpret=True)
    got = k3_paired(*map(t, (mu, sg, u2e, o2e, rou)), K, LAM, EPS)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert_close(getattr(got, name), w, 0, 1e-10 * np.abs(w).max(), name)


@pytest.mark.parametrize("k1", [12, 13, 21])
def test_k2_paired_arithmetic_matches_pallas(k1):
    mu, sg, u2e, o2e, rou = _inputs(M=17, N=23, seed=5)  # M, N ragged
    alpha, T = np.array([0.5, 0.3, 0.2]), 0.17
    want = edge_reduced_grads_pallas(*map(jnp.asarray, (mu, sg, u2e, o2e, rou, alpha)),
                                     jnp.asarray(T), k1, LAM, EPS, EDGE, rows=8,
                                     interpret=True)
    got = k2_paired(*map(t, (mu, sg, rou, alpha)), T, k1, LAM, EPS, EDGE)
    assert_fields_close(got, want, 1e-10, 1e-12)


@pytest.mark.parametrize("K", [4, 5, 9, 11])
def test_paired_rules_keep_the_moments(K):
    # pairs and centre integrate 1 and x^2 as the full rule does (weight exp(-x^2))
    rule = paired_rule(K)
    P = K * K // 2
    xi, w, wxi = rule[:P], rule[2 * P:3 * P], rule[3 * P:4 * P]
    assert 2 * w.sum() + rule[8 * P] == pytest.approx(math.pi, rel=1e-13)
    assert 2 * (wxi * xi).sum() == pytest.approx(math.pi / 2, rel=1e-13)
    r1 = paired_rule_1d(K)
    P1 = K // 2
    x, w1 = r1[:P1], r1[P1:2 * P1]
    assert (x > 0).all()
    assert 2 * w1.sum() + r1[4 * P1] == pytest.approx(math.sqrt(math.pi), rel=1e-13)
    assert 2 * (w1 * x * x).sum() == pytest.approx(math.sqrt(math.pi) / 2, rel=1e-13)
