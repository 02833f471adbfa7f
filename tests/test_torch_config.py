"""The port's configuration against the JAX package's, and its import boundary."""

import dataclasses
import math
import os
import subprocess
import sys

import pytest

import _torch_common  # noqa: F401  (one torch thread per worker)
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu_torch.models.gqmap import check_supported

PRESETS = ["__init__", "full_mixture", "super_entropy", "single_gaussian", "tpu_fast",
           "tpu_fast_super", "legacy_v1", "legacy_v2", "legacy_v3", "blockmatch_v2",
           "ctf_level"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make(pkg, preset, **kw):
    cls = pkg.GQMAPConfig
    return cls(**kw) if preset == "__init__" else getattr(cls, preset)(**kw)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_matches_jax_field_by_field(preset):
    port = dataclasses.asdict(_make(gqmap_tpu_torch, preset))
    ref = dataclasses.asdict(_make(gqmap_tpu, preset))
    assert list(port) == list(ref)
    for k, v in ref.items():
        assert port[k] == v, (preset, k, port[k], v)
    # overrides compose the same way
    assert (dataclasses.asdict(_make(gqmap_tpu_torch, preset, its=7, L=2))
            == dataclasses.asdict(_make(gqmap_tpu, preset, its=7, L=2)))


@pytest.mark.parametrize("tau", [8000.0, math.inf])
def test_step_schedule_matches_jax(tau):
    p = gqmap_tpu_torch.GQMAPConfig(step_tau=tau)
    r = gqmap_tpu.GQMAPConfig(step_tau=tau)
    assert p.step_const == r.step_const
    for it in (1, 10, 12345):
        assert p.step_at(it) == r.step_at(it)


def test_port_imports_without_jax():
    # every module of the port, the CLI and the I/O included: none pulls in
    # JAX or the JAX package
    code = ("import gqmap_tpu_torch, importlib, pkgutil, sys; "
            "names = [m.name for m in pkgutil.walk_packages(gqmap_tpu_torch.__path__, "
            "'gqmap_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert {'gqmap_tpu_torch.cli.main', 'gqmap_tpu_torch.io.preprocess', "
            "'gqmap_tpu_torch.models.ctf', 'gqmap_tpu_torch.parallel.halo', "
            "'gqmap_tpu_torch.ops.chebyshev', 'gqmap_tpu_torch.kernels.roofline', "
            "'gqmap_tpu_torch.bench', 'gqmap_tpu_torch.native'} <= set(names), "
            "names; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gqmap_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


DATA_TERMS = ["bicubic", "nearest", "quadratic", "chebyshev", "cosine"]


@pytest.mark.parametrize("data_term", DATA_TERMS + ["sinc"])
def test_every_data_term_jax_runs_is_supported(data_term):
    # the port refuses no data term the JAX package's make_problem takes, and
    # an unknown one raises ValueError in both
    import numpy as np

    from gqmap_tpu.models.gqmap import make_problem

    I1 = np.random.default_rng(0).uniform(0, 255, (8, 8))
    jcfg = gqmap_tpu.GQMAPConfig.tpu_fast(data_term=data_term, cheb_p=4, cheb_q=4)
    cfg = gqmap_tpu_torch.GQMAPConfig.tpu_fast(data_term=data_term)
    if data_term not in DATA_TERMS:
        with pytest.raises(ValueError, match="data_term"):
            make_problem(jcfg, I1, I1, gqmap_tpu.FlowRange(-1.0, 1.0, -1.0, 1.0))
        with pytest.raises(ValueError, match="data_term"):
            check_supported(cfg)
        return
    make_problem(jcfg, I1, I1, gqmap_tpu.FlowRange(-1.0, 1.0, -1.0, 1.0))
    check_supported(cfg)


def test_mesh_names_its_roadmap_item():
    # the multi-device solve (ROADMAP Queue 1 item 4) needs its ranks: with no
    # process group solve refuses a mesh before any work, naming the command
    # that starts them
    from gqmap_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        gqmap_tpu_torch.solve(gqmap_tpu_torch.GQMAPConfig.tpu_fast(), None, None,
                              mesh=make_mesh(4, rank=0), device="cpu")


@pytest.mark.parametrize("override", [
    dict(data_term="nearest"),
    dict(data_term="quadratic"),
    dict(edge_quad="tensor", edge_kind="truncquad"),
    dict(edge_kind="truncquad"),
    dict(gradient_estimator="autodiff"),
    dict(gradient_estimator="prewitt"),
    dict(window_rg=2),
])
def test_legacy_settings_are_supported(override):
    # the legacy families' settings are ported (ROADMAP Slice B item 13)
    check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(**override))


@pytest.mark.parametrize("override", [
    dict(edge_kernel="cuda", edge_kind="truncquad"),
    dict(edge_kernel="cuda", edge_kind="truncquad", edge_quad="tensor",
         gradient_estimator="autodiff"),
    dict(edge_kernel="cuda", gradient_estimator="autodiff", edge_kind="truncquad"),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="bicubic", window_rg=5),
    dict(node_kernel="cuda", data_term="bicubic", window_rg=5),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="bicubic", patch=2),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="chebyshev"),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="quadratic"),
])
def test_cuda_route_on_a_path_no_kernel_computes_raises(override):
    # K1 computes only the cosine term's Stein sums, K2 and K3 only
    # Charbonnier edges, K11 truncated-quadratic edges under the tensor rule
    # only (tpu_fast's edges are reduced), K12 the windowed bicubic term up
    # to a radius of 4 only, and under autodiff K1, K13 (the bicubic term
    # without a window, at patch 1 and 4), K16 (with a window of radius 1 to
    # 4), K6, K14 and K15 (Charbonnier edges) only: "cuda" there raises
    # instead of running the plain path
    with pytest.raises(ValueError, match="kernel K"):
        check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(**override))
    # "auto" and "torch" run the plain sums there
    for route in ("auto", "torch"):
        kw = {k: (route if k.endswith("_kernel") else v) for k, v in override.items()}
        check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(**kw))


@pytest.mark.parametrize("preset, override", [
    ("full_mixture", dict(window_rg=2)),
    ("legacy_v2", dict(data_term="bicubic")),
    ("tpu_fast", dict(data_term="bicubic", window_rg=2)),
])
def test_cuda_node_route_on_the_windowed_bicubic_term_is_supported(preset, override):
    # K12 computes the windowed bicubic term's sums
    check_supported(getattr(gqmap_tpu_torch.GQMAPConfig, preset)(node_kernel="cuda", **override))


@pytest.mark.parametrize("preset", ["legacy_v2", "legacy_v3", "blockmatch_v2"])
def test_cuda_node_route_on_the_nearest_lookup_presets_is_supported(preset):
    # K6 computes the nearest lookup's sums (legacy_v2 windowed,
    # blockmatch_v2 plain), K7 the Prewitt chain's (legacy_v3)
    check_supported(getattr(gqmap_tpu_torch.GQMAPConfig, preset)(node_kernel="cuda",
                                                                 edge_kernel="cuda"))


@pytest.mark.parametrize("override", [dict(data_term="bicubic", patch=4),
                                      dict(sweep_order="redblack"), dict(patch=4)])
def test_super_lattice_and_redblack_are_supported(override):
    # the super lattice (both data terms) and the red-black order are ported
    check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(**override))


@pytest.mark.parametrize("override", [dict(node_kernel="pallas"), dict(edge_kernel="xla"),
                                      dict(dtype="float16"), dict(data_term="sinc")])
def test_unknown_value_raises(override):
    with pytest.raises(ValueError):
        check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(**override))


def test_flagship_and_kernel_routes_are_supported():
    for route in ("auto", "cuda", "torch"):
        check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(node_kernel=route,
                                                             edge_kernel=route))
        check_supported(gqmap_tpu_torch.GQMAPConfig.full_mixture(edge_kernel=route))
    check_supported(gqmap_tpu_torch.GQMAPConfig.tpu_fast(alpha_update="projsplx",
                                                         dtype="float64"))
    for preset in ("super_entropy", "tpu_fast_super", "legacy_v1", "legacy_v2", "legacy_v3",
                   "blockmatch_v2", "ctf_level"):
        for order in ("jacobi", "redblack"):
            check_supported(getattr(gqmap_tpu_torch.GQMAPConfig, preset)(sweep_order=order))


@pytest.mark.parametrize("capability, ok", [((9, 0), True), ((8, 0), False), ((8, 9), False),
                                            ((10, 0), False), ((12, 0), False)])
def test_kernels_refuse_a_device_that_is_not_hopper(capability, ok):
    # the library holds sm_90a code only: any other capability is refused,
    # with the found capability named, before a launch
    from gqmap_tpu_torch.kernels import build

    if ok:
        build.require_capability(capability, "card")
    else:
        with pytest.raises(RuntimeError, match=rf"card has compute capability "
                                               rf"{capability[0]}\.{capability[1]}"):
            build.require_capability(capability, "card")


# ---- D7: each kernel routed by the shape it takes ---------------------------------------

C = gqmap_tpu_torch.GQMAPConfig
AD = dict(gradient_estimator="autodiff")
# (configuration, "node" or "edge", the term's kernel, the kernel that runs it:
# None where the shape is past the kernel's limit and the sums are plain torch)
SHAPE_CASES = {
    "cosine L=5": (C.tpu_fast(L=5), "node", "K1", "K1"),
    "cosine L=9 super": (C.tpu_fast_super(L=9), "node", "K1", "K1"),
    "cosine L=5 autodiff": (C.tpu_fast(L=5, **AD), "node", "K1", "K1"),
    "K4 K=64": (C.full_mixture(K=64), "node", "K4", "K4"),
    "K4 K=65": (C.full_mixture(K=65), "node", "K4", None),
    "K5 K=65": (C.full_mixture(data_term="chebyshev", K=65), "node", "K5", None),
    "K5 cheb_q=65": (C.full_mixture(data_term="chebyshev", cheb_q=65), "node", "K5", None),
    "K5 L K^2 past shared memory": (C.full_mixture(data_term="chebyshev", K=40, L=8), "node",
                                    "K5", None),
    "K6 K=65": (C.legacy_v2(K=65), "node", "K6", None),
    "K6 rfc=21": (C.legacy_v2(rfc=21), "node", "K6", None),
    "K6 K=65 autodiff": (C.legacy_v2(K=65, **AD), "node", "K6", None),
    "K7 K=65": (C.legacy_v3(K=65), "node", "K7", None),
    "K10 K=65": (C.legacy_v1(K=65), "node", "K10", "K10"),
    "K12 window_rg=5": (C.full_mixture(window_rg=5), "node", "K12", None),
    "K13 K=64": (C.full_mixture(K=64, **AD), "node", "K13", "K13"),
    "K13 K=65": (C.full_mixture(K=65, **AD), "node", "K13", None),
    "K13 patch 4 K=16": (C.super_entropy(K=16, **AD), "node", "K13", "K13"),
    "K13 patch 4 K=17": (C.super_entropy(K=17, **AD), "node", "K13", None),
    "K13 patch 2": (C.full_mixture(patch=2, **AD), "node", "K13", None),
    "K16 window_rg=4": (C.full_mixture(window_rg=4, **AD), "node", "K16", "K16"),
    "K16 window_rg=5": (C.full_mixture(window_rg=5, **AD), "node", "K16", None),
    "K16 K=17": (C.legacy_v2(data_term="bicubic", K=17, **AD), "node", "K16", None),
    "K2 K1=6200": (C.tpu_fast(edge_quad_k=6200), "edge", "K2", None),
    "K3 K=55": (C.full_mixture(K=55), "edge", "K3", "K3"),
    "K3 K=56": (C.full_mixture(K=56), "edge", "K3", None),
    "K3 K=40 float64": (C.full_mixture(K=40, dtype="float64"), "edge", "K3", None),
    "K3 K=1": (C.full_mixture(K=1), "edge", "K3", None),
    "K11 K=56": (C.legacy_v1(K=56), "edge", "K11", None),
    "K11 K=40 float64": (C.legacy_v1(K=40, dtype="float64"), "edge", "K11", None),
    "K14 K=70": (C.full_mixture(K=70, **AD), "edge", "K14", "K14"),
    "K14 K=71": (C.full_mixture(K=71, **AD), "edge", "K14", None),
    "K14 K=50 float64": (C.full_mixture(K=50, dtype="float64", **AD), "edge", "K14", None),
    "K15 K1=6200": (C.tpu_fast(edge_quad_k=6200, **AD), "edge", "K15", None),
}


@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_kernels_are_routed_by_the_shape_they_take(case):
    # _node_kernel / _edge_kernel name the term's kernel where it takes the
    # configuration's shape and None past its limit, where "auto" runs the
    # plain sums; check_supported refuses "cuda" there, naming the kernel and
    # its limit, and takes "auto" and "torch" (no card needed)
    from gqmap_tpu_torch.models import gqmap as pg

    cfg, side, term, kernel = SHAPE_CASES[case]
    field = f"{side}_kernel"
    assert getattr(pg, f"_{side}_term")(cfg) == term
    assert getattr(pg, f"_{side}_kernel")(cfg) == kernel
    assert (pg._shape_limit(term, cfg) is None) == (kernel is not None)
    for route in ("auto", "torch"):
        check_supported(dataclasses.replace(cfg, **{field: route}))
    cuda = dataclasses.replace(cfg, **{field: "cuda"})
    if kernel is not None:
        check_supported(cuda)
        return
    with pytest.raises(ValueError, match=rf"{field}='cuda' asks for kernel {term}, which does "
                                         rf"not take this configuration's shape: {term} takes"):
        check_supported(cuda)


@pytest.mark.parametrize("preset, kw", [
    ("full_mixture", dict(K=65, L=2)),
    ("full_mixture", dict(K=65, L=2, gradient_estimator="autodiff")),
    ("legacy_v2", dict(K=65)),
    ("legacy_v3", dict(K=65)),
])
def test_a_shape_past_its_kernels_limit_sweeps_through_the_plain_version(monkeypatch, preset,
                                                                         kw):
    # "auto" past a kernel's limit never calls the kernel's route: the sweep is
    # the "torch" routes' sweep, bit for bit
    import numpy as np
    import torch

    from gqmap_tpu_torch.models import gqmap as pg

    cfg = getattr(C, preset)(dtype="float64", quad_chunk=700, **kw)
    node, edge = pg._node_term(cfg), pg._edge_term(cfg)
    for side, term in (("node", node), ("edge", edge)):
        if getattr(pg, f"_{side}_kernel")(cfg) is not None:
            continue

        def refuse(*a, term=term, **k):
            raise AssertionError(f"the sweep called {term}'s kernel route past its limit")

        table = {"K4": pg._NODE_GQ, "K6": pg._NODE_NEAREST, "K7": pg._NODE_CHAIN,
                 "K13": pg._NODE_ADJOINT}.get(term) or pg._EDGE_ROUTES[term]
        monkeypatch.setitem(table, "auto", refuse)
    shape = (8, 10)
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, shape)
    fr = gqmap_tpu_torch.FlowRange(-2.0, 2.0, -2.0, 2.0)
    problem = pg.make_problem(cfg, I1, np.roll(I1, 1, 1), fr, device="cpu")
    state = pg.init_state(cfg, fr, shape, device="cpu")
    state = state._replace(sigmau=state.sigmau * 0 + 0.3, sigmav=state.sigmav * 0 + 0.4)
    got, _ = pg.make_sweep(cfg, shape)(problem, state)
    plain = dataclasses.replace(cfg, node_kernel="torch", edge_kernel="torch")
    want, _ = pg.make_sweep(plain, shape)(problem, state)
    for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
        assert bool(torch.isfinite(getattr(got, f)).all()), f
        assert torch.equal(getattr(got, f), getattr(want, f)), f
