"""The port's ``bench`` (``gqmap_tpu_torch/bench.py``, the CLI's ``bench``)
and the teardown of the CLI's process group (ROADMAP Queue 3, D4), on the
CPU.

``bench``'s frames against the root ``bench.py``'s (the JAX package's), its
measurement on a small pair, and the command's one JSON line. D4: two gloo
ranks each run ``run --devices 2`` through ``cli.main.main`` in-process;
after it returns, no process group may be left (a rank that exits with one
alive can abort in its destructor).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import _torch_common  # noqa: F401  (one torch thread per worker)
from _torch_common import write_sequence
from gqmap_tpu_torch import bench
from gqmap_tpu_torch.cli import main as cli
from gqmap_tpu_torch.config import FlowRange

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "mode", "steady_state", "from_init", "device"}


def _small_pair():
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (12, 16))
    return I1, np.roll(I1, 1, axis=1), FlowRange(-2.0, 2.0, -2.0, 2.0)


def test_bench_frames_are_bench_py_s(tmp_path, monkeypatch, capsys):
    # no Teddy under GQMAP_DATA: the root bench.py's synthetic pair and range
    sys.path.insert(0, REPO)
    try:
        import bench as jax_bench
    finally:
        sys.path.remove(REPO)
    monkeypatch.setenv("GQMAP_DATA", str(tmp_path))
    I1, I2, fr = bench.load_problem_images()
    J1, J2, jfr = jax_bench.load_problem_images()
    np.testing.assert_array_equal(I1, J1)
    np.testing.assert_array_equal(I2, J2)
    assert tuple(fr) == tuple(jfr)
    assert "synthetic" in capsys.readouterr().err
    # Teddy where the data root holds it, with its GT's flow range
    write_sequence(tmp_path, "Teddy", 24, 28)
    I1, _, fr = bench.load_problem_images()
    assert I1.shape == (24, 28) and fr.maxu > fr.minu
    assert "Teddy" in capsys.readouterr().err


def test_bench_falls_back_on_any_load_error(tmp_path, monkeypatch, capsys):
    # ROADMAP Queue 3, D5: a Teddy that does not load for another reason than
    # a missing file (here the PNG reader's missing imageio) gives the root
    # bench.py's synthetic pair, as that script's catch-all does, and the
    # cause on stderr
    from gqmap_tpu_torch.io import dataset

    def no_imageio(*a, **k):
        raise ImportError("No module named 'imageio'")

    write_sequence(tmp_path, "Teddy", 24, 28)
    monkeypatch.setenv("GQMAP_DATA", str(tmp_path))
    monkeypatch.setattr(dataset, "load_sequence", no_imageio)
    I1, I2, fr = bench.load_problem_images()
    r = np.random.default_rng(0)
    want = r.uniform(0, 255, (376, 452))
    k = np.ones(5) / 5
    want = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, want)
    want = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, want)
    np.testing.assert_array_equal(I1, want)
    np.testing.assert_array_equal(I2, np.roll(want, 1, axis=1))
    assert tuple(fr) == (-10.0, 2.0, -2.0, 2.0)
    err = capsys.readouterr().err
    assert "ImportError" in err and "imageio" in err and "synthetic" in err


@pytest.mark.parametrize("steady", [False, True])
def test_measure_on_a_small_pair(monkeypatch, steady):
    monkeypatch.setattr(bench, "load_problem_images", _small_pair)
    rate = bench.measure("cosine", warm=2, seg_len=3, steady=steady, device="cpu")
    assert np.isfinite(rate) and rate > 0


def test_measure_needs_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(bench, "load_problem_images", _small_pair)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure("cosine", warm=1, seg_len=1)


def test_cli_bench_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "load_problem_images", _small_pair)
    monkeypatch.setattr(bench, "WARM", 2)
    monkeypatch.setattr(bench, "SEG_LEN", 3)
    cli.main(["bench", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == KEYS
    assert got["metric"] == "gqmap_torch_converged_sweep_throughput"
    assert got["value"] == got["steady_state"] > 0 and got["from_init"] > 0
    assert got["vs_baseline"] == 1.0 and got["mode"] == "cosine"
    assert got["device"] == "cpu" and got["unit"] == "Mpixel-sweeps/s/cpu"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_ends_the_process_group_it_formed(tmp_path):
    # D4: each rank runs the command in-process, then reports whether a
    # process group is still alive; on the parent's code it is on every run
    write_sequence(tmp_path, "Venus", 16, 20)
    args = ["run", "--seq", "Venus", "--preprocessed", "--preset", "tpu_fast", "--dtype",
            "float64", "--k", "3", "--l", "2", "--cheb-p", "8", "--cheb-q", "4",
            "--quad-chunk", "0", "--its", "2", "--eval-every", "2", "--quiet", "--device",
            "cpu", "--devices", "2"]
    code = ("import sys, torch.distributed as d; from gqmap_tpu_torch.cli.main import main; "
            "main(sys.argv[1:]); print('group alive after the command:', d.is_initialized())")
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(GQMAP_DATA=str(tmp_path), OMP_NUM_THREADS="1", WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    except BaseException:
        for p in procs:
            p.kill()  # the exact processes started here
        for p in procs:
            p.wait()
        raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        assert "group alive after the command: False" in out, f"rank {r}:\n{out[-3000:]}"
    assert sum(line.startswith("{") for out in outs for line in out.splitlines()) == 1
