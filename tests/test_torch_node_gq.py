"""Kernel K4's module: the exact path's bicubic node quadrature.

``node_gq_torch`` (the plain version, ``gq_accumulate`` over
``make_node_pot_bicubic``) is held to the JAX package's ``gq_accumulate``
over its ``make_node_pot_bicubic`` (the XLA scan the JAX sweep runs) in
float64 at 1e-10 of each sum's largest magnitude: full_mixture's K = 9 at
L = 3, super_entropy's K = 11 on 4 x 4 pixel blocks, ctf_level's K = 11 at
L = 1, a shard's block (frame 1 at a pixel origin), and NaN queries (NaN
where JAX gives NaN). The CUDA kernel (``csrc/node_gq.cu``) runs only on the
card, so its per-site loop is transcribed here in torch float64 step for
step (its point order, the rule's 1-D values multiplied out, the
NaN-keeping clamp and the cell of a NaN query, the row-by-row tap sum, the
lanes of a site and their xor-shuffle tree) and held to JAX at the same
tolerance: an algebra error shows here before any card run. The kernel's
second variant, ``"v2"``, is transcribed the same way (``k4_v2_transcribed``:
the rule's per-point constant table, lanes over points, the displacement
and the cubic weights once a point with the 0.25 in the y weights, the
border test on global coordinates, the separable (patch + 3)^2 window
and the block total, v1's per-pixel sample where the test fails or the
query is NaN, the xor tree) and held to JAX at 1e-10 in every case, at the
rho clamp, on NaN queries and on super-lattice blocks that straddle the
clamp on each side of the frame; the window in shared memory holds the
table's own values, so the transcription reads the table.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gqmap_tpu_torch
from _torch_common import t
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu.ops import potentials as jpot
from gqmap_tpu.ops.gq import gq_accumulate
from gqmap_tpu.ops.quadrature import build_table
from gqmap_tpu_torch.convert import problem_from_numpy, state_from_numpy
from gqmap_tpu_torch.kernels import node_gq
from gqmap_tpu_torch.models.gqmap import check_supported, init_state, make_problem, make_sweep
from gqmap_tpu_torch.ops.gq import GQRaw

SQRT2 = math.sqrt(2.0)
LAM, EPS = 1.0, 1e-6
# name: (K, L, patch, frame shape, origin, local_image_shape) of each case
CASES = {
    "full_mixture K=9 L=3": (9, 3, 1, (12, 16), None, None),
    "super_entropy K=11 patch=4": (11, 3, 4, (16, 20), None, None),
    "ctf_level K=11 L=1": (11, 1, 1, (12, 16), None, None),
    "shard block patch=1": (9, 2, 1, (16, 20), (4, 8), (8, 8)),
    "shard block patch=4": (11, 1, 4, (24, 32), (8, 16), (16, 12)),
    "super blocks straddle the border": (11, 2, 4, (16, 24), None, None),
}
STRADDLE = "super blocks straddle the border"
VERSIONS = ["plain", "kernel transcribed", "v2 transcribed"]


def _inputs(K, L, patch, shape, local, rho=0.9, seed=0, straddle=False):
    """Frames (smooth noise in [0, 255]), VV = pad_cubic(I2), and a state on
    the lattice of the covered block whose queries also leave the frame."""
    r = np.random.default_rng(seed + 7 * K + L)
    I1 = r.uniform(0, 255, shape)
    I2 = np.roll(I1, 1, axis=1) + r.normal(0, 5, shape)
    VV = np.asarray(jinterp.pad_cubic(jnp.asarray(I2)))
    Ml, Nl = shape if local is None else local
    site = (L, Ml // patch, Nl // patch)
    st = dict(muu=r.normal(0, 3, site), muv=r.normal(0, 3, site),
              su=r.uniform(0.05, 3, site), sv=r.uniform(0.05, 3, site),
              pn=r.uniform(-rho, rho, site))
    if straddle:
        # narrow sigmas, and the edge blocks' means half a block off the
        # frame: their pixels straddle the clamp on the left, right, top and
        # bottom (the first pixel clamped, the last not, or the reverse)
        st["su"], st["sv"] = r.uniform(0.02, 0.3, site), r.uniform(0.02, 0.3, site)
        st["muu"][:, :, 0], st["muu"][:, :, -1] = -0.55 * patch, 0.55 * patch
        st["muv"][:, 0, :], st["muv"][:, -1, :] = -0.55 * patch, 0.55 * patch
    return I1, VV, st


def _jax_sums(I1, VV, st, K, patch, origin, local):
    jo = None if origin is None else tuple(jnp.int32(o) for o in origin)
    f = jpot.make_node_pot_bicubic(jnp.asarray(I1), jnp.asarray(VV), LAM, EPS, patch=patch,
                                   origin=jo, local_image_shape=local)
    return gq_accumulate(f, *(jnp.asarray(st[k]) for k in ("muu", "muv", "su", "sv", "pn")),
                         build_table(K, 0, np.float64))


def _port_args(I1, VV, st):
    return (t(I1), t(VV), *(t(st[k]) for k in ("muu", "muv", "su", "sv", "pn")))


def _assert_sums_match(got, want, shape):
    for name in GQRaw._fields:
        g = getattr(got, name)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape == shape, name
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
        scale = np.abs(w[~nan]).max()
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=1e-10 * scale, err_msg=name)


# ---- the kernel's arithmetic, transcribed -------------------------------------------

def _cubic_weights(f):
    return (((2.0 - f) * f - 1.0) * f, (3.0 * f - 5.0) * f * f + 2.0,
            ((4.0 - 3.0 * f) * f + 1.0) * f, (f - 1.0) * f * f)


def _sample(flat, N2, Xq, Yq, Nf, Mf):
    """``sample_bicubic`` of ``csrc/node_gq.cu``: the clamp by compare and
    select (NaN kept), the cell (1, 1) for a NaN query, each row's four taps
    against the x weights, then the rows against the y weights."""
    Xq = torch.where(Xq < 1, 1.0, torch.where(Xq > Nf, float(Nf), Xq))
    Yq = torch.where(Yq < 1, 1.0, torch.where(Yq > Mf, float(Mf), Yq))
    fx, fy = torch.floor(Xq), torch.floor(Yq)
    fx = torch.where(fx > Nf - 1, float(Nf - 1), fx)
    fy = torch.where(fy > Mf - 1, float(Mf - 1), fy)
    wx, wy = _cubic_weights(Xq - fx), _cubic_weights(Yq - fy)
    ix = torch.where(fx >= 1, fx, 1.0).long()
    iy = torch.where(fy >= 1, fy, 1.0).long()
    base = (iy - 1) * N2 + (ix - 1)
    v = torch.zeros_like(Xq)
    for dr in range(4):
        r = base + dr * N2
        row = wx[0] * flat[r]
        for dc in range(1, 4):
            row = row + wx[dc] * flat[r + dc]
        v = v + wy[dr] * row
    return v * 0.25


def k4_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, patch=1, origin=None):
    """``node_gq_kernel`` of ``csrc/node_gq.cu``: lane ``g`` of each site's
    ``G`` lanes runs every point over its block pixels ``g, g + G, ...``,
    then the lanes' partial sums meet by the xor tree and lane 0 writes."""
    L, M, N = muu.shape
    P, G = patch, node_gq.group_lanes(patch)
    rule = node_gq.node_rule(K)
    x, w = rule[:K].tolist(), rule[K:].tolist()
    M2, N2 = VV.shape
    Nf, Mf = N2 - 2, M2 - 2
    r0, c0 = (0, 0) if origin is None else origin
    flat = VV.reshape(-1)
    o1e, o2e = su * SQRT2, sv * SQRT2
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    lanes = []
    for g in range(G):
        e, sxi, sxj, sxixj, sx2a, sx2m = (torch.zeros_like(muu) for _ in range(6))
        for q in range(g, P * P, G):
            a, b = divmod(q, P)
            rows = (r0 + torch.arange(M) * P + a).reshape(M, 1)
            cols = (c0 + torch.arange(N) * P + b).reshape(1, N)
            i1 = I1[rows, cols]
            jj, ii = (cols + 1).to(muu.dtype), (rows + 1).to(muu.dtype)
            for j in range(K):
                xj, wj = x[j], w[j]
                sxj_, txj, xj2 = s * xj, tt * xj, xj * xj
                for i in range(K):
                    xi = x[i]
                    zi = s * xi + txj
                    zj = tt * xi + sxj_
                    V = _sample(flat, N2, jj + (o1e * zi + muu), ii + (o2e * zj + muv), Nf, Mf)
                    d = i1 - V
                    fv = (w[i] * wj) * torch.sqrt(eps + d * d)
                    xi2 = xi * xi
                    e = e + fv
                    sxi = sxi + xi * fv
                    sxj = sxj + xj * fv
                    sxixj = sxixj + (xi * xj) * fv
                    sx2a = sx2a + (xi2 + xj2 - 1.0) * fv
                    sx2m = sx2m + (xi2 - xj2) * fv
        lanes.append((e, sxi, sxj, sxixj, sx2a, sx2m))
    off = G // 2
    while off:
        lanes = [tuple(a + b for a, b in zip(lanes[g], lanes[g ^ off])) for g in range(G)]
        off //= 2
    e, sxi, sxj, sxixj, sx2a, sx2m = lanes[0]
    nl = -lam
    return GQRaw(nl * e, nl * (s * sxi + tt * sxj), nl * (tt * sxi + s * sxj), nl * sx2a,
                 nl * sx2m, nl * sxixj)


def _quarter_weights(f):
    return (((0.5 - 0.25 * f) * f - 0.25) * f, (0.75 * f - 1.25) * f * f + 0.5,
            ((1.0 - 0.75 * f) * f + 0.25) * f, (0.25 * f - 0.25) * f * f)


def k4_v2_transcribed(I1, VV, muu, muv, su, sv, pn, K, lam, eps, patch=1, origin=None):
    """``node_gq_v2_kernel`` of ``csrc/node_gq.cu``: the per-point constant
    table, lane ``g`` of each site's ``G`` lanes over the points ``g, g + G,
    ...``; per point one displacement, floor, fraction and weight set; where
    the border test holds, the block's (P + 3)^2 window row by row (each
    window row's taps against the x weights for every pixel column, then
    each pixel row's four window rows against the quarter y weights) and the
    block total; elsewhere v1's per-pixel sample; the six sums on ``w_i w_j
    F``, the xor tree, lane 0 writes."""
    L, M, N = muu.shape
    P = patch
    G = node_gq.v2_tile(P)[0]
    rule = node_gq.node_rule(K)
    x, w = rule[:K].tolist(), rule[K:].tolist()
    pts = [(x[i], x[j], w[i] * w[j], x[i] * x[j], x[i] * x[i] + x[j] * x[j] - 1.0,
            x[i] * x[i] - x[j] * x[j]) for j in range(K) for i in range(K)]
    M2, N2 = VV.shape
    Nf, Mf = N2 - 2, M2 - 2
    r0, c0 = (0, 0) if origin is None else origin
    flat = VV.reshape(-1)
    sp, sm = torch.sqrt(1.0 + pn), torch.sqrt(1.0 - pn)
    s, tt = (sp + sm) * 0.5, (sp - sm) * 0.5
    A1, B1, A2, B2 = su * SQRT2 * s, su * SQRT2 * tt, sv * SQRT2 * tt, sv * SQRT2 * s
    rows0 = (r0 + torch.arange(M) * P).reshape(M, 1)
    cols0 = (c0 + torch.arange(N) * P).reshape(1, N)
    jj0, ii0 = (cols0 + 1).to(muu.dtype), (rows0 + 1).to(muu.dtype)
    i1 = [I1[rows0 + q // P, cols0 + q % P] for q in range(P * P)]
    lanes = []
    for g in range(G):
        acc = [torch.zeros_like(muu) for _ in range(6)]
        for p in range(g, K * K, G):
            xi, xj, wij, xixj, ca, cm = pts[p]
            x1 = A1 * xi + (B1 * xj + muu)
            x2 = A2 * xi + (B2 * xj + muv)
            X0, Y0 = jj0 + x1, ii0 + x2
            fx, fy = torch.floor(X0), torch.floor(Y0)
            shared = (X0 >= 1) & (fx <= Nf - P) & (Y0 >= 1) & (fy <= Mf - P)
            wx, wy = _cubic_weights(X0 - fx), _quarter_weights(Y0 - fy)
            ix = torch.where(shared, fx, 1.0).long()  # any cell in the table where unused
            iy = torch.where(shared, fy, 1.0).long()
            base = (iy - 1) * N2 + (ix - 1)
            V = [[None] * P for _ in range(P)]
            for r in range(P + 3):
                tp = [flat[base + r * N2 + k] for k in range(P + 3)]
                for b in range(P):
                    h = wx[0] * tp[b]
                    for k in range(1, 4):
                        h = h + wx[k] * tp[b + k]
                    for a in range(P):
                        if r == a:
                            V[a][b] = wy[0] * h
                        elif a < r < a + 4:
                            V[a][b] = V[a][b] + wy[r - a] * h
            F_shared = torch.zeros_like(muu)
            for q in range(P * P):
                d = i1[q] - V[q // P][q % P]
                F_shared = F_shared + torch.sqrt(eps + d * d)
            F_pixels = torch.zeros_like(muu)
            for q in range(P * P):
                a, b = divmod(q, P)
                Vq = _sample(flat, N2, (jj0 + b) + x1, (ii0 + a) + x2, Nf, Mf)
                d = i1[q] - Vq
                F_pixels = F_pixels + torch.sqrt(eps + d * d)
            fv = wij * torch.where(shared, F_shared, F_pixels)
            for k, cst in enumerate((1.0, xi, xj, xixj, ca, cm)):
                acc[k] = acc[k] + (fv if k == 0 else cst * fv)
        lanes.append(acc)
    off = G // 2
    while off:
        lanes = [[u + v for u, v in zip(lanes[g], lanes[g ^ off])] for g in range(G)]
        off //= 2
    e, sxi, sxj, sxixj, sx2a, sx2m = lanes[0]
    nl = -lam
    return GQRaw(nl * e, nl * (s * sxi + tt * sxj), nl * (tt * sxi + s * sxj), nl * sx2a,
                 nl * sx2m, nl * sxixj)


def _version_sums(version, args, K, patch=1, origin=None, local=None, quad_chunk=0):
    if version == "plain":
        return node_gq.node_gq_torch(*args, K, LAM, EPS, patch=patch, origin=origin,
                                     local_image_shape=local, quad_chunk=quad_chunk)
    fn = k4_transcribed if version == "kernel transcribed" else k4_v2_transcribed
    return fn(*args, K, LAM, EPS, patch=patch, origin=origin)


# ---- the tests ------------------------------------------------------------------------

@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("case", list(CASES))
def test_node_sums_match_jax(case, version):
    K, L, patch, shape, origin, local = CASES[case]
    I1, VV, st = _inputs(K, L, patch, shape, local, straddle=case == STRADDLE)
    want = _jax_sums(I1, VV, st, K, patch, origin, local)
    got = _version_sums(version, _port_args(I1, VV, st), K, patch, origin, local, quad_chunk=K)
    _assert_sums_match(got, want, st["muu"].shape)


def test_straddle_case_takes_both_forms_on_every_side():
    # the edge blocks of the straddle case: on each side of the frame a
    # point's first pixel is clamped and its last is not (or the reverse), so
    # v2's border test fails there (the per-pixel sample) and holds inside
    K, L, patch, shape, _, _ = CASES[STRADDLE]
    _, VV, st = _inputs(K, L, patch, shape, None, straddle=True)
    Nf, Mf = VV.shape[1] - 2, VV.shape[0] - 2
    x = node_gq.node_rule(K)[:K]
    xi, xj = np.tile(x, K), np.repeat(x, K)
    p = st["pn"][..., None]
    sp, sm = np.sqrt(1 + p), np.sqrt(1 - p)
    s, t = (sp + sm) / 2, (sp - sm) / 2
    _, M, N = st["muu"].shape
    X0 = (np.arange(N)[:, None] * patch + 1 + st["muu"][..., None]
          + SQRT2 * st["su"][..., None] * (s * xi + t * xj))
    Y0 = (np.arange(M)[:, None, None] * patch + 1 + st["muv"][..., None]
          + SQRT2 * st["sv"][..., None] * (t * xi + s * xj))
    last = patch - 1
    for side, first_clamped, last_clamped in (
            ("left", X0[:, :, 0] < 1, X0[:, :, 0] + last < 1),
            ("right", X0[:, :, -1] > Nf, X0[:, :, -1] + last > Nf),
            ("top", Y0[:, 0] < 1, Y0[:, 0] + last < 1),
            ("bottom", Y0[:, -1] > Mf, Y0[:, -1] + last > Mf)):
        assert (first_clamped != last_clamped).any(), side
    shared = ((X0 >= 1) & (np.floor(X0) <= Nf - patch)
              & (Y0 >= 1) & (np.floor(Y0) <= Mf - patch))
    assert shared.any() and not shared[:, :, 0].all() and not shared[:, :, -1].all()
    assert not shared[:, 0].all() and not shared[:, -1].all()


@pytest.mark.parametrize("version", VERSIONS)
def test_node_sums_at_the_rho_clamp_match_jax(version):
    # |rho| = 1 - 1e-5, the corr_tor corner: t ~ s, the whitened points
    # collapse onto the diagonal
    K, L, patch, shape, _, _ = CASES["full_mixture K=9 L=3"]
    I1, VV, st = _inputs(K, L, patch, shape, None)
    st["pn"] = 0.99999 * np.sign(st["pn"])
    want = _jax_sums(I1, VV, st, K, patch, None, None)
    got = _version_sums(version, _port_args(I1, VV, st), K)
    _assert_sums_match(got, want, st["muu"].shape)


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("field", ["muu", "muv", "su", "pn"])
def test_nan_query_gives_nan_where_jax_does(field, version):
    # a NaN mean, sigma or correlation at one site: every sum of that site is
    # NaN in both engines (at patch 4 too: only its own block), the others
    # agree; the kernel's clamp keeps the NaN and reads the table at (1, 1),
    # and v2's border test fails a NaN query by comparison
    K, L, patch, shape, _, _ = CASES["super_entropy K=11 patch=4"]
    I1, VV, st = _inputs(K, L, patch, shape, None)
    st[field][1, 2, 3] = np.nan
    want = _jax_sums(I1, VV, st, K, patch, None, None)
    assert np.isnan(np.asarray(want.Ei)).sum() == 1
    got = _version_sums(version, _port_args(I1, VV, st), K, patch)
    _assert_sums_match(got, want, st["muu"].shape)


@pytest.mark.parametrize("K, patch, want", [(9, 1, "v2"), (11, 4, "v2"), (16, 1, "v2"),
                                            (17, 1, "v1"), (9, 3, "v1"), (5, 2, "v1")])
def test_default_variant_is_v2_where_it_is_compiled(K, patch, want):
    assert node_gq.resolve_variant(None, K, patch) == want
    assert node_gq.resolve_variant("v1", K, patch) == "v1"
    if want == "v1":
        with pytest.raises(ValueError, match="v2"):
            node_gq.resolve_variant("v2", K, patch)
    with pytest.raises(ValueError, match="unknown"):
        node_gq.resolve_variant("v3", K, patch)


def test_v2_tiles_and_window_budget():
    # 256 lanes a CTA: 4 lanes on 8 x 8 sites, 16 on 4 x 4 super sites; the
    # rule table (K^2 points of 8 values) and the window share 44 KB
    for patch, (G, TR, TC) in ((1, (4, 8, 8)), (4, (16, 4, 4))):
        assert node_gq.v2_tile(patch) == (G, TR, TC) and G * TR * TC == 256
    assert node_gq.v2_ctas((3, 376, 452), 1) == 3 * 47 * 57
    assert node_gq.v2_ctas((3, 94, 113), 4) == 3 * 24 * 29
    assert node_gq.window_budget(11, torch.float32) == 44 * 1024 - 121 * 32
    assert node_gq.window_budget(9, torch.float64) == 44 * 1024 - 81 * 64


@pytest.mark.parametrize("patch, G", [(1, 1), (2, 4), (3, 8), (4, 16), (6, 32), (8, 32)])
def test_group_lanes(patch, G):
    # a site's lanes: the largest power of two within min(patch^2, 32), so
    # every group lies inside one warp
    assert node_gq.group_lanes(patch) == G and 32 % G == 0


def test_transcription_with_several_pixels_a_lane_matches_plain():
    # patch 3 (9 pixels, 8 lanes: lane 0 takes pixels 0 and 8) and patch 6
    # (36 pixels, 32 lanes), against the plain version, which JAX holds above
    for patch, shape in ((3, (9, 12)), (6, (12, 12))):
        I1, VV, st = _inputs(5, 1, patch, shape, None)
        args = _port_args(I1, VV, st)
        got = k4_transcribed(*args, 5, LAM, EPS, patch=patch)
        want = node_gq.node_gq_torch(*args, 5, LAM, EPS, patch=patch)
        _assert_sums_match(got, want, st["muu"].shape)


def test_node_rule_multiplies_out_to_the_table():
    # every tensor-rule value of the plain table is a product of the rule's
    # 1-D values, in the table's flat order (XJ outer, XI inner)
    K = 9
    rule = node_gq.node_rule(K)
    x, w = rule[:K], rule[K:]
    tab = build_table(K, 0, np.float64)
    np.testing.assert_array_equal(tab.xi[0], np.tile(x, K))
    np.testing.assert_array_equal(tab.xj[0], np.repeat(x, K))
    np.testing.assert_array_equal(tab.wiwj[0], np.tile(w, K) * np.repeat(w, K))
    assert node_gq.node_rule(K, np.float32).dtype == np.float32


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    K, L, patch, shape, _, _ = CASES["super_entropy K=11 patch=4"]
    I1, VV, st = _inputs(K, L, patch, shape, None)
    args = (*_port_args(I1, VV, st), K, LAM, EPS)
    got = node_gq.node_gq(*args, patch=patch)
    want = node_gq.node_gq_torch(*args, patch=patch)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert node_gq.node_gq_cuda.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        node_gq.node_gq_cuda(*args, patch=patch)
    assert node_gq.node_gq_cuda.launches == 0


def test_cpu_sweep_routes_the_bicubic_term_through_k4():
    # "cuda" sends the exact path's node term to the kernel, which refuses
    # CPU tensors rather than fall back; "auto" runs its plain version there
    cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(node_kernel="cuda", edge_kernel="torch",
                                                   dtype="float64")
    I1 = _inputs(9, 3, 1, (12, 16), None)[0]
    fr = gqmap_tpu_torch.FlowRange(-2.0, 2.0, -2.0, 2.0)
    problem = make_problem(cfg, I1, I1, fr, device="cpu")
    state = init_state(cfg, fr, (12, 16), device="cpu")
    with pytest.raises(RuntimeError, match="node_gq_cuda needs CUDA"):
        make_sweep(cfg, (12, 16))(problem, state)
    make_sweep(gqmap_tpu_torch.GQMAPConfig.full_mixture(dtype="float64"), (12, 16))(
        problem, state)
    assert node_gq.node_gq_cuda.launches == 0


@pytest.mark.parametrize("route", ["auto", "cuda", "torch"])
def test_full_mixture_accepts_every_node_route(route):
    for preset in ("full_mixture", "super_entropy", "single_gaussian", "ctf_level"):
        check_supported(getattr(gqmap_tpu_torch.GQMAPConfig, preset)(node_kernel=route))


@pytest.mark.parametrize("override", [dict(window_rg=5, data_term="bicubic"),
                                      dict(gradient_estimator="autodiff", window_rg=5),
                                      dict(data_term="chebyshev", cheb_q=96),
                                      dict(gradient_estimator="autodiff", patch=2)])
def test_cuda_node_route_without_a_kernel_raises(override):
    # the windowed bicubic term beyond K12's largest radius (4), under
    # autodiff beyond K16's (4) and on a lattice of 2 x 2 blocks (K13 takes
    # patch 1 and 4) and a Chebyshev series of more v-degrees than kernel K5
    # keeps in registers stay plain: "cuda" there raises
    with pytest.raises(ValueError, match="kernel K"):
        check_supported(gqmap_tpu_torch.GQMAPConfig.full_mixture(node_kernel="cuda", **override))
    check_supported(gqmap_tpu_torch.GQMAPConfig.full_mixture(node_kernel="auto", **override))


def test_convert_defaults_to_the_gpu(monkeypatch):
    # convert is an entry point: with no device it takes the GPU, and raises
    # where there is none; a CPU run asks for device="cpu"
    I1 = np.zeros((4, 5))
    fields = dict(I1=I1, I2_tab=np.zeros((6, 7)), interior=np.ones((4, 5), bool),
                  rng=(-1.0, 1.0, -1.0, 1.0), cheb=None)
    st = dict(w=np.zeros(1), muu=np.zeros((1, 4, 5)), muv=np.zeros((1, 4, 5)),
              sigmau=np.ones((1, 4, 5)), sigmav=np.ones((1, 4, 5)), pn=np.zeros((1, 4, 5)),
              rou=np.zeros((2, 2, 1, 4, 5)), temperature=np.float64(0), it=np.int32(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, arg in ((problem_from_numpy, fields), (state_from_numpy, st)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(arg)
    assert problem_from_numpy(fields, device="cpu").I1.device.type == "cpu"
    assert state_from_numpy(st, device="cpu").muu.device.type == "cpu"


def test_make_problem_frames_are_contiguous():
    # the CLI crops the frames so the mesh divides the lattice; K4 reads
    # frame 1 flat, so make_problem stores both frames contiguous
    cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(dtype="float64")
    I1 = _inputs(9, 1, 1, (12, 19), None)[0]
    p = make_problem(cfg, I1[:, :16], I1[:, 1:17], gqmap_tpu_torch.FlowRange(-1.0, 1.0, -1.0, 1.0),
                     device="cpu")
    assert p.I1.is_contiguous() and p.I2_tab.is_contiguous()
    assert np.array_equal(p.I1.numpy(), I1[:, :16])
