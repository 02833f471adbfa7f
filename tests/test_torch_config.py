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
    code = ("import gqmap_tpu_torch, sys; "
            "assert not [m for m in sys.modules if m.split('.')[0] == 'jax']")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


@pytest.mark.parametrize("override, item", [
    (dict(data_term="bicubic", patch=4), "item 10"),
    (dict(data_term="nearest"), "item 13"),
    (dict(data_term="quadratic"), "item 13"),
    (dict(data_term="chebyshev"), "Do not port"),
    (dict(edge_quad="tensor", edge_kind="truncquad"), "item 13"),
    (dict(edge_kind="truncquad"), "item 13"),
    (dict(gradient_estimator="autodiff"), "item 13"),
    (dict(gradient_estimator="prewitt"), "item 13"),
    (dict(sweep_order="redblack"), "item 11"),
    (dict(patch=4), "item 10"),
    (dict(window_rg=2), "item 13"),
])
def test_unported_config_names_its_roadmap_item(override, item):
    cfg = gqmap_tpu_torch.GQMAPConfig.tpu_fast(**override)
    with pytest.raises(NotImplementedError, match=item):
        check_supported(cfg)


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
