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
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="bicubic", window_rg=2),
    dict(node_kernel="cuda", data_term="bicubic", window_rg=5),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="bicubic", patch=4),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="chebyshev"),
    dict(node_kernel="cuda", gradient_estimator="autodiff", data_term="quadratic"),
])
def test_cuda_route_on_a_path_no_kernel_computes_raises(override):
    # K1 computes only the cosine term's Stein sums, K2 and K3 only
    # Charbonnier edges, K11 truncated-quadratic edges under the tensor rule
    # only (tpu_fast's edges are reduced), K12 the windowed bicubic term up
    # to a radius of 4 only, and under autodiff K1, K13 (the bicubic term
    # without a window, one pixel a site), K6, K14 and K15 (Charbonnier edges)
    # only: "cuda" there raises instead of running the plain path
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
