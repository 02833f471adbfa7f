"""The port's drivers against the JAX package's: the coarse-to-fine pyramid,
the lambda_s sweep, ``solve(out_dir=...)`` and the command line.

Both engines start every solve from the JAX package's initial state
(``jax.random`` and ``torch.Generator`` give different bits from one seed):
the port's ``init_state`` is patched to hand out JAX's for the same
configuration, range, shape and seed, as ``tests/test_torch_exact.py`` does.
Then, in float64: each pyramid level's MAP and the final flow within 1e-8,
each lambda's best AEPE within 1e-8 with the same ``summary()`` text, and
the same best AEPE within 1e-8 from both command lines on one dataset. The
PNGs of ``out_dir`` decode equal to the JAX writer's. The datasets are
written under ``tmp_path`` (``GQMAP_DATA``); the Middlebury data is not used.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from _torch_common import port_state, shifted_pair, smooth_flow_pair, write_sequence
import gqmap_tpu
import gqmap_tpu_torch
from gqmap_tpu.cli import main as jcli
from gqmap_tpu.io.flo import read_flo as jread_flo
from gqmap_tpu.models import ctf as jctf
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.models import param_sweep as jsweep
from gqmap_tpu_torch.cli import main as pcli
from gqmap_tpu_torch.io.dataset import load_sequence
from gqmap_tpu_torch.models import ctf as pctf
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.models import param_sweep as psweep
from gqmap_tpu_torch.models.blockmatch import block_matching_init

STABLE = dict(step0=0.03, corr_tor=0.95)  # tests/test_torch_exact.py's multi-sweep setting


def _jax_cfg(cfg):
    return gqmap_tpu.GQMAPConfig(**dataclasses.asdict(cfg))


@pytest.fixture
def shared_init(monkeypatch):
    """The port's ``init_state`` hands out the JAX package's initial state."""

    def init_state(cfg, rng, image_shape, seed=None, device=None):
        js = jg.init_state(_jax_cfg(cfg), gqmap_tpu.FlowRange(*rng), tuple(image_shape), seed)
        return port_state(js)

    monkeypatch.setattr(pg, "init_state", init_state)


# ---- the coarse-to-fine pyramid

CTF = dict(K=5, its=20, eval_every=10, dtype="float64", corr_tor=0.99)


@pytest.mark.parametrize("level_init", ["zero", "random"])
def test_ctf_levels_agree_with_jax(shared_init, level_init):
    I1, I2, gt = smooth_flow_pair()
    jr = jctf.solve_coarse_to_fine(gqmap_tpu.GQMAPConfig.ctf_level(**CTF), I1, I2, gt,
                                   scales=(0.5, 1.0), level_init=level_init)
    pr = pctf.solve_coarse_to_fine(gqmap_tpu_torch.GQMAPConfig.ctf_level(**CTF), I1, I2, gt,
                                   scales=(0.5, 1.0), level_init=level_init, device="cpu")
    assert [lv.map.shape for lv in pr.levels] == [(32, 32, 2), (64, 64, 2)]
    for p, j in zip(pr.levels, jr.levels):
        assert p.iters == j.iters == 20
        np.testing.assert_allclose(p.map, j.map, rtol=0, atol=1e-8)
        np.testing.assert_allclose(p.Energy, j.Energy, rtol=1e-8)
    np.testing.assert_allclose(pr.flow, jr.flow, rtol=0, atol=1e-8)
    assert pr.aepe == pytest.approx(jr.aepe, rel=0, abs=1e-8)


def test_ctf_pyramid_compounds_its_error_in_both_engines(shared_init):
    # ROADMAP Queue 3, P5, a property of the reference: over the preset's
    # four scales each level's residual solve leaves an error that the
    # next level's warp doubles, and the clamp box [0, max |GT| x scale]
    # cannot take an overshoot back, so on this pair the accumulated flow
    # ends further from the GT than the zero flow, in the JAX engine as in
    # the port. The levels agree to 1e-8 at the coarsest and then separate
    # slowly through the warps (2e-4 in the MAP at the finest), so the
    # final AEPEs are held to 1e-5.
    I1, I2, gt = smooth_flow_pair()
    kw = dict(K=5, its=30, eval_every=30, dtype="float64", corr_tor=0.99)
    jr = jctf.solve_coarse_to_fine(gqmap_tpu.GQMAPConfig.ctf_level(**kw), I1, I2, gt)
    pr = pctf.solve_coarse_to_fine(gqmap_tpu_torch.GQMAPConfig.ctf_level(**kw), I1, I2, gt,
                                   device="cpu")
    zero = float(np.mean(np.sqrt((gt[1:-1, 1:-1] ** 2).sum(-1))))
    assert [lv.map.shape[:2] for lv in pr.levels] == [(8, 8), (16, 16), (32, 32), (64, 64)]
    np.testing.assert_allclose(pr.levels[0].map, jr.levels[0].map, rtol=0, atol=1e-8)
    assert pr.aepe == pytest.approx(jr.aepe, rel=0, abs=1e-5)
    assert pr.aepe > 1.5 * zero and jr.aepe > 1.5 * zero, (pr.aepe, jr.aepe, zero)


def test_ctf_runs_and_improves_on_the_port():
    # tests/test_pipeline.py's claim, on the port alone (its own init)
    I1, I2, gt = smooth_flow_pair()
    cfg = gqmap_tpu_torch.GQMAPConfig.ctf_level(K=5, its=150, eval_every=75, dtype="float64")
    res = pctf.solve_coarse_to_fine(cfg, I1, I2, gt, scales=(0.5, 1.0), device="cpu")
    assert res.flow.shape == (64, 64, 2) and np.isfinite(res.aepe)
    assert res.aepe < 1.3  # the zero flow's AEPE is 1.45; must do clearly better


def test_ctf_refuses_an_unknown_level_init():
    I1, I2, gt = smooth_flow_pair(16, 16)
    cfg = gqmap_tpu_torch.GQMAPConfig.ctf_level(K=3, its=2)
    with pytest.raises(ValueError, match="unknown level_init 'warm'"):
        pctf.solve_coarse_to_fine(cfg, I1, I2, gt, scales=(1.0,), level_init="warm",
                                  device="cpu")


def test_ctf_warp_agrees_with_jax():
    I1, _, gt = smooth_flow_pair(24, 28)
    warp = -gt * 2.5  # reaches outside the frame: the nearest fill covers it
    got = pctf._warp_image(I1, warp, "cpu")
    want = jctf._warp_image(I1, warp)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# ---- the lambda_s sweep

def test_sweep_lambdas_agrees_with_jax(shared_init, tmp_path):
    I1, I2, gt = shifted_pair()
    kw = dict(K=5, L=2, its=20, eval_every=10, dtype="float64", **STABLE)
    lams = [0.5, 2.0]
    jr = jsweep.sweep_lambdas(gqmap_tpu.GQMAPConfig.full_mixture(**kw), I1, I2, gt,
                              lambdas=lams, log_path=tmp_path / "jax.txt")
    pr = psweep.sweep_lambdas(gqmap_tpu_torch.GQMAPConfig.full_mixture(**kw), I1, I2, gt,
                              lambdas=lams, log_path=tmp_path / "port.txt", device="cpu")
    np.testing.assert_array_equal(pr.lambdas, jr.lambdas)
    np.testing.assert_allclose(pr.best_aepe, jr.best_aepe, rtol=0, atol=1e-8)
    assert pr.best_lambda == jr.best_lambda
    assert pr.summary() == jr.summary()
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


# ---- solve(out_dir=...)

def _decode(path):
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


@pytest.mark.parametrize("preset, patch", [("full_mixture", 1), ("super_entropy", 4)])
def test_out_dir_pngs_equal_jax_writer(tmp_path, preset, patch):
    I1, I2, gt = shifted_pair(24, 32)
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(K=3, its=3, eval_every=2,
                                                       dtype="float64")
    assert cfg.patch == patch
    maps = {}
    res = gqmap_tpu_torch.solve(cfg, I1, I2, gt_flow=gt, out_dir=str(tmp_path / "port"),
                                device="cpu",
                                callback=lambda it, st, m, a, lp: maps.setdefault(it, m))
    assert res.iters == 3 and sorted(maps) == [1, 2, 3]
    assert sorted(os.listdir(tmp_path / "port")) == ["1.png", "2.png", "3.png"]
    crop = 2 * patch if patch > 1 else 0  # the repelem'd MAP loses a patch a side
    for it, m in maps.items():
        jg._write_viz(_jax_cfg(cfg), m, str(tmp_path / "jax"), it)
        got, want = (_decode(tmp_path / pkg / f"{it}.png") for pkg in ("port", "jax"))
        assert got.shape == want.shape == (24 - crop, 32 - crop, 3)
        assert np.array_equal(got, want)
    # the writer alone, on a map with large and zero flow
    m = np.random.default_rng(1).normal(size=maps[1].shape) * 4
    m[0, 0] = 0.0
    pg._write_viz(cfg, m, str(tmp_path / "port"), 99)
    jg._write_viz(_jax_cfg(cfg), m, str(tmp_path / "jax"), 99)
    assert np.array_equal(*(_decode(tmp_path / pkg / "99.png") for pkg in ("port", "jax")))


def test_out_dir_without_imageio_raises_import_error(tmp_path, monkeypatch):
    # as the JAX package does: only a run with out_dir needs imageio
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    I1, I2, gt = shifted_pair()
    cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(K=3, its=2, eval_every=1, dtype="float64")
    for call in (lambda: gqmap_tpu_torch.solve(cfg, I1, I2, gt_flow=gt, out_dir=str(tmp_path),
                                               device="cpu"),
                 lambda: jg.solve(_jax_cfg(cfg), I1, I2, gt_flow=gt, out_dir=str(tmp_path))):
        with pytest.raises(ImportError):
            call()
    assert gqmap_tpu_torch.solve(cfg, I1, I2, gt_flow=gt, device="cpu").iters == 2


# ---- the command line

@pytest.fixture
def data(tmp_path, monkeypatch):
    root = tmp_path / "data"
    monkeypatch.setenv("GQMAP_DATA", str(root))
    for i, name in enumerate(("Venus", "Dimetrodon")):
        write_sequence(root, name, 32, 40, seed=i)
    return root


def _cli(module, argv, capsys):
    capsys.readouterr()
    module.main(argv)
    return capsys.readouterr().out


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


SMALL = ["--device", "cpu", "--dtype", "float64", "--k", "3", "--l", "2", "--its", "4",
         "--eval-every", "2", "--quiet"]


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as e:
        pcli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("run", "suite", "ctf", "sweep", "bench"):
        assert cmd in out
    with pytest.raises(SystemExit):
        pcli.main(["run", "--help"])
    out = capsys.readouterr().out
    assert "--device" in out and "--devices" in out and "--reset-at" in out
    with pytest.raises(SystemExit):
        pcli.main(["bench", "--help"])
    out = capsys.readouterr().out
    assert "--device" in out and "--devices" not in out


def test_cli_run(data, capsys):
    out = _last_json(_cli(pcli, ["run", "--seq", "Venus", *SMALL], capsys))
    assert out["seq"] == "Venus" and out["iters"] == 4 and np.isfinite(out["best_aepe"])
    # the printed best AEPE is the direct solve's on the same frames and seed
    seq = load_sequence("Venus")
    cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(K=3, L=2, its=4, eval_every=2,
                                                   dtype="float64")
    res = gqmap_tpu_torch.solve(cfg, seq.img1, seq.img2, gt_flow=seq.gt_flow, device="cpu")
    assert out["best_aepe"] == res.best_aepe


def test_cli_run_out(data, tmp_path, capsys):
    out_dir = tmp_path / "out"
    out = _last_json(_cli(pcli, ["run", "--seq", "Venus", "--out", str(out_dir), *SMALL], capsys))
    assert sorted(os.listdir(out_dir)) == ["1.png", "2.png", "4.png", "Venus.flo", "Venus.npz",
                                           "metrics.jsonl"]
    npz = np.load(out_dir / "Venus.npz")
    assert set(npz.files) == {"mu", "sigma", "alpha", "AEPE", "Energy", "logP", "map"}
    assert npz["mu"].shape == (32, 40, 2, 2) and npz["Energy"].shape == (4,)
    assert np.nanmin(npz["AEPE"]) == out["best_aepe"]
    flo = jread_flo(str(out_dir / "Venus.flo"))  # the JAX package reads the port's file
    assert np.array_equal(flo, npz["map"].astype(np.float32))
    recs = [json.loads(x) for x in open(out_dir / "metrics.jsonl")]
    evals = [r for r in recs if r.get("event") == "eval"]
    assert [r["it"] for r in evals] == [1, 2, 4]
    assert min(r["aepe"] for r in evals) == out["best_aepe"]
    assert recs[0]["seq"] == "Venus" and recs[0]["cfg"]["K"] == 3


def _direct(seq, cfg, **kw):
    return gqmap_tpu_torch.solve(cfg, seq.img1, seq.img2, gt_flow=seq.gt_flow, device="cpu",
                                 **kw).best_aepe


@pytest.mark.parametrize("flags", [["--preprocessed"], ["--init", "blockmatch"],
                                   ["--reset-at", "3"], ["--st-preprocess"],
                                   ["--preset", "tpu_fast", "--scale", "0.8"]])
def test_cli_run_options_match_direct_solve(data, capsys, flags):
    out = _last_json(_cli(pcli, ["run", "--seq", "Dimetrodon", *SMALL, *flags], capsys))
    preset = flags[1] if flags[0] == "--preset" else "full_mixture"
    cfg = getattr(gqmap_tpu_torch.GQMAPConfig, preset)(K=3, L=2, its=4, eval_every=2,
                                                       dtype="float64")
    seq = load_sequence("Dimetrodon", scale=0.8 if "--scale" in flags else 1.0,
                        preprocessed="--preprocessed" in flags,
                        st_preprocess="--st-preprocess" in flags, device="cpu")
    kw = {}
    if "--init" in flags:
        kw["init_flow"] = block_matching_init(seq.img1, seq.img2, U=7, V=7, device="cpu")
    if "--reset-at" in flags:
        kw["reset_at"] = 3
    assert out["best_aepe"] == _direct(seq, cfg, **kw)
    assert out["iters"] == 4


def test_cli_run_checkpoint_resume(data, tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    first = _last_json(_cli(pcli, ["run", "--seq", "Venus", *SMALL, "--checkpoint", ck,
                                   "--checkpoint-every", "2"], capsys))
    assert first["iters"] == 4 and os.path.exists(ck)
    argv = ["run", "--seq", "Venus", *SMALL[:-5], "--its", "6", "--eval-every", "2", "--quiet"]
    resumed = _last_json(_cli(pcli, argv + ["--checkpoint", ck, "--resume"], capsys))
    full = _last_json(_cli(pcli, argv, capsys))
    assert resumed["iters"] == full["iters"] == 6
    assert resumed["best_aepe"] == pytest.approx(full["best_aepe"], rel=1e-12)


def test_cli_suite(data, capsys):
    out = _cli(pcli, ["suite", "--seqs", "Venus,Dimetrodon", *SMALL], capsys)
    res = _last_json(out)
    assert sorted(res["per_seq"]) == ["Dimetrodon", "Venus"]
    assert res["avg_aepe"] == pytest.approx(np.mean(list(res["per_seq"].values())), rel=1e-15)
    assert "Venus: best AEPE = " in out
    cfg = gqmap_tpu_torch.GQMAPConfig.full_mixture(K=3, L=2, its=4, eval_every=2,
                                                   dtype="float64")
    assert res["per_seq"]["Venus"] == _direct(load_sequence("Venus"), cfg)


def test_cli_ctf(data, capsys):
    out = _last_json(_cli(pcli, ["ctf", "--seq", "Venus", "--preset", "ctf_level",
                                 *SMALL[:4], "--k", "3", "--its", "4", "--eval-every", "2",
                                 "--quiet"], capsys))
    assert out["seq"] == "Venus" and out["level_init"] == "zero" and np.isfinite(out["aepe"])


def test_cli_sweep(data, tmp_path, capsys):
    log = tmp_path / "sweep.txt"
    out = _cli(pcli, ["sweep", "--seq", "Venus", *SMALL, "--range", "0.5", "1.5", "3",
                      "--log", str(log)], capsys)
    lines = out.strip().splitlines()
    assert len(lines) == 4 and lines[-1].startswith("Best lambda s = ")
    assert log.read_text() == out


# the same dataset through both command lines, from one initial state
BOTH = {
    "run": ["run", "--seq", "Venus"],
    "suite": ["suite", "--seqs", "Venus,Dimetrodon"],
    "ctf": ["ctf", "--seq", "Dimetrodon", "--preset", "ctf_level", "--level-init", "random"],
    "sweep": ["sweep", "--seq", "Venus", "--range", "0.5", "1.5", "2"],
}


@pytest.mark.parametrize("cmd", list(BOTH))
def test_both_command_lines_agree(data, shared_init, capsys, cmd):
    common = ["--dtype", "float64", "--k", "3", "--its", "4", "--eval-every", "2", "--quiet"]
    if cmd != "ctf":
        common += ["--l", "2"]
    argv = BOTH[cmd] + common
    got = _cli(pcli, argv + ["--device", "cpu"], capsys)
    want = _cli(jcli, argv, capsys)
    if cmd == "sweep":
        assert got == want  # summary() text, to 5 decimals
        return
    g, w = _last_json(got), _last_json(want)
    key = {"run": "best_aepe", "suite": "avg_aepe", "ctf": "aepe"}[cmd]
    assert g[key] == pytest.approx(w[key], rel=0, abs=1e-8)
    for name in g.get("per_seq", {}):
        assert g["per_seq"][name] == pytest.approx(w["per_seq"][name], rel=0, abs=1e-8)


@pytest.mark.parametrize("cmd", list(BOTH))
def test_cli_devices_raises(data, capsys, cmd):
    # --devices must equal the world size: without a process group it raises
    # and prints the command that starts the ranks
    argv = BOTH[cmd] + ["--device", "cpu", "--devices", "2"]
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node 2"):
        pcli.main(argv)
    assert ("python -m torch.distributed.run --nproc-per-node 2 -m gqmap_tpu_torch.cli.main "
            + " ".join(argv)) in capsys.readouterr().err


@pytest.mark.parametrize("cmd", list(BOTH))
def test_cli_without_a_card_raises(data, monkeypatch, capsys, cmd):
    # no GPU and no --device: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(BOTH[cmd] + ["--k", "3", "--its", "2"])
    assert capsys.readouterr().out == ""


if __name__ == "__main__":
    # ROADMAP Queue 3, P5 at a larger size, the port alone in float64 on the
    # CPU: PYTHONPATH=. python tests/test_torch_drivers.py 188 226 prints
    # each level's residual AEPE, where its MAP's u lies in its clamp box,
    # and the final AEPE beside the zero flow's, on chip_smoke.py's pair at
    # ctf_level(its=300) over the preset's scales
    from chip_smoke import flow_sequence
    from gqmap_tpu_torch.ops.flowviz import flow_to_color

    M, N = (int(x) for x in sys.argv[1:3])
    I1, I2, gt = flow_sequence(0, "cpu", M, N)
    clean = flow_to_color(gt.astype(np.float64)).flo
    res = pctf.solve_coarse_to_fine(gqmap_tpu_torch.GQMAPConfig.ctf_level(its=300,
                                                                          eval_every=300),
                                    I1, I2, gt, verbose=True, device="cpu")
    for lv, scale in zip(res.levels, (1 / 8, 1 / 4, 1 / 2, 1)):
        q = np.quantile(lv.map[..., 0], [0, 0.1, 0.5, 0.9, 1])
        print(f"level {lv.map.shape[:2]}: MAP u quantiles (0, 10, 50, 90, 100%) "
              f"{np.round(q, 4).tolist()}, box [0, {clean[..., 0].max() * scale:.4f}]")
    print(f"{M}x{N}: final AEPE {res.aepe:.4f}, the zero flow's "
          f"{np.mean(np.sqrt((clean[1:-1, 1:-1] ** 2).sum(-1))):.4f}")
