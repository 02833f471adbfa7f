"""The port's multi-device solve (``gqmap_tpu_torch/parallel``) against the
JAX package's explicit halo sweep on 8 virtual CPU devices.

The port runs as 4 gloo ranks on the CPU (``tests/_torch_parallel_worker.py``,
which imports nothing of JAX), launched once for the module: the fixture
writes each case's inputs, made by the JAX package, starts the ranks,
computes JAX's results while they run and reads the ranks' outputs. Every
case runs in float64. Tolerance: ``rtol=1e-9, atol=1e-12`` on every GQState
field and 1e-9 relative on the energy and ptdmu (the shards sum in another
order than one device), as ``tests/test_halo.py`` holds JAX's halo sweep to
its single-device sweep.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from scipy.ndimage import gaussian_filter

from _torch_common import port_state, t
from gqmap_tpu import FlowRange as JFlowRange
from gqmap_tpu import GQMAPConfig as JConfig
from gqmap_tpu.models import gqmap as jg
from gqmap_tpu.parallel import mesh as jmesh
from gqmap_tpu.parallel.halo import make_halo_sweep as jhalo_sweep
from gqmap_tpu_torch import GQMAPConfig
from gqmap_tpu_torch.config import FlowRange
from gqmap_tpu_torch.convert import problem_from_numpy
from gqmap_tpu_torch.kernels import edge_reduced_gq as k2
from gqmap_tpu_torch.models import gqmap as pg
from gqmap_tpu_torch.ops.gq import EDGE
from gqmap_tpu_torch.parallel import (Mesh, factor_2d, halo, make_mesh, make_mesh_for_shape,
                                      mesh as pmesh)

WORKER = os.path.join(os.path.dirname(__file__), "_torch_parallel_worker.py")
RANKS = 4
RTOL, ATOL = 1e-9, 1e-12
FR = (-2.0, 2.0, -2.0, 2.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def toy(cfg, M=16, N=16, seed=0, **problem_kw):
    """``tests/test_halo.py``'s toy: smoothed noise and its 1-px roll, the
    JAX problem and init state."""
    r = np.random.default_rng(seed)
    I1 = gaussian_filter(r.uniform(0, 255, (M, N)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    fr = JFlowRange(*FR)
    if cfg.data_term in ("cosine", "chebyshev"):
        problem = jg.make_problem(cfg, I1, I2, fr)
    else:
        problem = jg.make_problem(cfg, I1, I2)._replace(rng=fr)
    if problem_kw:
        problem = problem._replace(**problem_kw)
    return problem, jg.init_state(cfg, fr, I1.shape), (I1, I2)


def _problem_arrays(p):
    out = dict(p_I1=np.asarray(p.I1), p_I2_tab=np.asarray(p.I2_tab),
               p_interior=np.asarray(p.interior), p_rng=np.asarray(tuple(p.rng), float))
    if p.cheb is not None:
        out.update({"p_" + k: np.asarray(v) for k, v in p.cheb._asdict().items()})
    if p.init_flow is not None:
        out["p_init_flow"] = np.asarray(p.init_flow)
    if p.grad_tabs is not None:
        out["p_grad0"], out["p_grad1"] = (np.asarray(g) for g in p.grad_tabs)
    return out


def port_problem(p):
    """The port's Problem holding exactly the JAX Problem's arrays."""
    a = _problem_arrays(p)
    cheb = ({k: a["p_" + k] for k in ("coeffs", "lo_u", "hi_u", "lo_v", "hi_v")}
            if p.cheb is not None else None)
    return problem_from_numpy(dict(I1=a["p_I1"], I2_tab=a["p_I2_tab"],
                                   interior=a["p_interior"], rng=a["p_rng"], cheb=cheb,
                                   init_flow=a.get("p_init_flow")), device="cpu")


def _state_arrays(s, prefix="s_"):
    return {prefix + k: np.asarray(v) for k, v in s._asdict().items()}


def _cfgs():
    fm = JConfig.full_mixture(K=5, L=2, dtype="float64")
    fast = JConfig.tpu_fast(K=5, L=2, dtype="float64", cheb_p=24, cheb_q=12, quad_chunk=0)
    return dict(
        fm_2x2=(fm, (1, 2, 2), 3, {}),
        fm_1x4=(fm, (1, 1, 4), 3, {}),
        fm_4x1=(fm, (1, 4, 1), 3, {}),
        fast_2x2=(fast, (1, 2, 2), 3, {}),
        # tests/test_halo.py::test_halo_spectral_terms_match_single[chebyshev] at P1's
        # corr_tor: at the preset's, rho reaches the clamp in the second sweep and the
        # port's single-process sweep leaves JAX's by 1.3e-9 in the third (ROADMAP P1)
        cheb_2x2=(dataclasses.replace(fast, data_term="chebyshev", corr_tor=0.99), (1, 2, 2),
                  3, {}),
        # P2's setting, as tests/test_torch_redblack.py: at the preset's step the
        # red-black order separates the port's single-process sweep from JAX's by
        # 1.6e-9 in 3 sweeps on this toy, with no shard involved (ROADMAP P2)
        redblack_2x2=(dataclasses.replace(fm, sweep_order="redblack", step0=0.03,
                                          corr_tor=0.95), (1, 2, 2), 3, {}),
        super_2x2=(JConfig.super_entropy(K=3, dtype="float64"), (1, 2, 2), 3, dict(M=32, N=32)),
        v1_2x2=(JConfig.legacy_v1(K=5, L=1, dtype="float64"), (1, 2, 2), 3,
                dict(init_flow=True)),
        v2_2x2=(JConfig.legacy_v2(K=5, dtype="float64"), (1, 2, 2), 1, {}),
        v3_2x2=(JConfig.legacy_v3(K=5, dtype="float64"), (1, 2, 2), 1, {}),
        autodiff_2x2=(dataclasses.replace(fm, gradient_estimator="autodiff"), (1, 2, 2), 1, {}),
    )


SWEEP_CASES = list(_cfgs())
SOLVE_CFG = dict(K=5, L=2, dtype="float64", cheb_p=24, cheb_q=12, quad_chunk=0, its=30,
                 eval_every=10, corr_tor=0.99)


def _write_inputs(d):
    """Every case's inputs; returns what the JAX side needs to compute its
    results: ``{name: (cfg, problem, state, mesh_shape, n, image_shape)}``."""
    jobs = {}
    for name, (cfg, mesh, n, extra) in _cfgs().items():
        M, N = extra.get("M", 16), extra.get("N", 16)
        kw = {}
        if extra.get("init_flow"):
            init = np.zeros((M, N, 2))
            init[..., 0] = 1.0
            kw["init_flow"] = jnp.asarray(init)
        problem, state, _ = toy(cfg, M, N, **kw)
        meta = dict(cfg=dataclasses.asdict(cfg), mesh=mesh, kind="sweep", n=n,
                    image_shape=(M, N))
        np.savez(os.path.join(d, f"in_{name}.npz"), meta=json.dumps(meta),
                 **_problem_arrays(problem), **_state_arrays(state))
        jobs[name] = (cfg, problem, state, mesh, n, (M, N))
    # test_parallel.py's test_batched_dp_sharded: two states, dp = 2
    cfg = JConfig.full_mixture(K=5, L=2, dtype="float64")
    problem, s0, _ = toy(cfg, seed=0)
    _, s1, _ = toy(cfg, seed=1)
    batch = jax.tree_util.tree_map(lambda *xs: np.stack(xs), s0, s1)
    meta = dict(cfg=dataclasses.asdict(cfg), mesh=(2, 1, 2), kind="batched", n=1,
                image_shape=(16, 16))
    np.savez(os.path.join(d, "in_batched.npz"), meta=json.dumps(meta),
             **_problem_arrays(problem), **_state_arrays(batch))
    jobs["batched"] = (cfg, problem, (s0, s1))
    # solve(mesh=...) on the main path's preset at P1's corr_tor
    cfg = JConfig.tpu_fast(**SOLVE_CFG)
    problem, state, (I1, I2) = toy(cfg)
    gt = np.zeros((16, 16, 2))
    gt[..., 0] = 1.0
    meta = dict(cfg=dataclasses.asdict(cfg), mesh=(1, 2, 2), kind="solve", n=cfg.its,
                image_shape=(16, 16))
    np.savez(os.path.join(d, "in_solve.npz"), meta=json.dumps(meta), I1=I1, I2=I2, gt=gt,
             **_problem_arrays(problem), **_state_arrays(state))
    jobs["solve"] = (I1, I2, gt, state)
    return jobs


def _jax_results(jobs):
    """JAX's halo sweep of each sweep case, its single-device sweep of each
    batched state."""
    out = {}
    for name in SWEEP_CASES:
        cfg, problem, state, (_, px, py), n, shape = jobs[name]
        if cfg.gradient_estimator == "autodiff":
            continue  # held to the port's single-process autodiff sweep
        mesh = JMesh(np.asarray(jax.devices()[:px * py]).reshape(px, py), ("x", "y"))
        sweep = jhalo_sweep(cfg, shape, mesh)
        energy, ptdmu = [], []
        for _ in range(n):
            state, aux = sweep(problem, state)
            energy.append(float(aux.energy))
            ptdmu.append(float(aux.ptdmu))
        out[name] = (jax.tree_util.tree_map(np.asarray, state), energy, ptdmu)
    cfg, problem, states = jobs["batched"]
    ref = jax.jit(jg.make_sweep(cfg, (16, 16)))
    out["batched"] = [jax.tree_util.tree_map(np.asarray, ref(problem, s)) for s in states]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the 4 ranks once; returns (output dir, inputs, JAX results)."""
    d = str(tmp_path_factory.mktemp("torch_parallel"))
    jobs = _write_inputs(d)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(RANKS), str(port), d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(RANKS)]
    try:
        ref = _jax_results(jobs)
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except BaseException:
        for p in procs:
            p.kill()  # the exact PIDs started here
        for p in procs:
            p.wait()
        raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return d, jobs, ref


def _out(d, name):
    return dict(np.load(os.path.join(d, f"out_{name}.npz")))


def _fields_close(got, want):
    """Every GQState field of ``got`` (a dict) against ``want`` (a GQState or
    a dict of arrays)."""
    want = want._asdict() if hasattr(want, "_asdict") else want
    for f in jg.GQState._fields:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=RTOL, atol=ATOL,
                                   err_msg=f)


@pytest.mark.parametrize("name", [n for n in SWEEP_CASES if not n.startswith("autodiff")])
def test_sharded_sweep_matches_jax_halo_sweep(ranks, name):
    d, _, ref = ranks
    got = _out(d, name)
    want, energy, ptdmu = ref[name]
    _fields_close(got, want)
    np.testing.assert_allclose(got["energy"], energy, rtol=RTOL)
    np.testing.assert_allclose(got["ptdmu"], ptdmu, rtol=RTOL)


def test_sharded_autodiff_sweep_matches_single_process(ranks):
    # the gradient flows back through each halo exchange (HaloRoll's backward)
    d, jobs, _ = ranks
    cfg, problem, state, *_ = jobs["autodiff_2x2"]
    pcfg = GQMAPConfig(**dataclasses.asdict(cfg))
    st, aux = pg.make_sweep(pcfg, (16, 16))(port_problem(problem), port_state(state))
    got = _out(d, "autodiff_2x2")
    _fields_close(got, {f: getattr(st, f).numpy() for f in st._fields})
    np.testing.assert_allclose(got["energy"], [float(aux.energy)], rtol=RTOL)
    np.testing.assert_allclose(got["ptdmu"], [float(aux.ptdmu)], rtol=RTOL)


def test_batched_dp_sharded_matches_single_device(ranks):
    # a (2, 1, 2) mesh: each dp index runs its state through its (x, y) halo sweep
    d, _, ref = ranks
    for b, (want, aux) in enumerate(ref["batched"]):
        got = _out(d, f"batched_dp{b}_0")
        _fields_close(got, want)
        np.testing.assert_allclose(got["energy"], float(aux.energy), rtol=RTOL)


def test_solve_with_mesh_matches_single_process(ranks):
    # 30 sweeps at corr_tor = 0.99 (ROADMAP P1): every rank returns the same
    # traces, and the AEPE trace is the single-process solve's to 1e-8
    d, jobs, _ = ranks
    I1, I2, gt, state = jobs["solve"]
    cfg = GQMAPConfig.tpu_fast(**SOLVE_CFG)
    want = pg.solve(cfg, I1, I2, gt_flow=gt, flow_range=FlowRange(*FR), seed=3,
                    init=port_state(state), device="cpu")
    got = [_out(d, f"solve_r{r}") for r in range(RANKS)]
    for r in range(1, RANKS):
        for k in ("AEPE", "Energy", "logP", "mu", "map"):
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"rank {r} {k}")
    evals = np.isfinite(want.AEPE)
    assert evals.sum() == 4  # it = 1, 10, 20, 30
    np.testing.assert_array_equal(np.isfinite(got[0]["AEPE"]), evals)
    np.testing.assert_allclose(got[0]["AEPE"][evals], want.AEPE[evals], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[0]["Energy"], want.Energy, rtol=1e-8)


def test_solve_with_mesh_resumes_from_its_checkpoint(ranks):
    # rank 0 writes the gathered state at it = 20; each rank resumes from its block
    d, _, _ = ranks
    whole, resumed = _out(d, "solve_r0"), _out(d, "solve_resumed")
    for k in ("AEPE", "Energy", "mu"):
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


# ---- plain functions: no processes

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 18])
def test_factor_2d_matches(n):
    assert factor_2d(n) == jmesh.factor_2d(n)


@pytest.mark.parametrize("n,dp", [(1, 1), (4, 1), (8, 1), (8, 2), (6, 3), (8, 4)])
def test_make_mesh_shape_matches(n, dp):
    want = jmesh.make_mesh(n, dp=dp)
    got = make_mesh(n, dp=dp, rank=0)
    assert tuple(got.devices.shape) == tuple(want.devices.shape)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)


@pytest.mark.parametrize("M,N,n,dp", [(16, 16, 8, 1), (18, 22, 8, 1), (17, 13, 8, 1),
                                      (94, 113, 8, 2), (188, 226, 4, 1), (7, 5, 6, 1)])
def test_make_mesh_for_shape_matches(M, N, n, dp):
    # awkward shapes: the largest dividing (x, y) in the budget, spare ranks unused
    want = jmesh.make_mesh_for_shape(M, N, n, dp=dp)
    got = make_mesh_for_shape(M, N, n, dp=dp, rank=0)
    assert tuple(got.devices.shape) == tuple(want.devices.shape)


def test_mesh_blocks_rings_and_refusal():
    m = Mesh(2, 2, 3, rank=9)  # d = 1, i = 1, j = 0
    assert m.coords == (1, 1, 0)
    assert m.origin(8, 9) == (4, 0)
    rx, ry = m.ring("x"), m.ring("y")
    assert (rx.n, rx.prev, rx.next) == (2, 6, 6)
    assert (ry.n, ry.prev, ry.next) == (3, 11, 10)
    with pytest.raises(ValueError, match="not divisible by mesh"):
        m.block(9, 9)
    with pytest.raises(ValueError, match="not divisible by mesh"):
        halo.make_halo_sweep(GQMAPConfig.full_mixture(), (15, 16), Mesh(1, 2, 2, 0))
    with pytest.raises(ValueError, match="outside the mesh"):
        Mesh(1, 2, 2, rank=5).coords


def test_state_sharding_specs_match_jax():
    # the lattice axes of each GQState field are JAX's PartitionSpecs
    want = jmesh.state_sharding(jmesh.make_mesh(8, dp=2), batched=True)
    got = pmesh.state_sharding(batched=True)
    for f in got._fields:
        assert tuple(getattr(got, f)) == tuple(getattr(want, f).spec), f


@pytest.mark.parametrize("shift,axis", [(1, -2), (-1, -2), (1, -1), (-1, -1)])
def test_halo_roll_one_shard_is_torch_roll(shift, axis):
    x = t(np.random.default_rng(0).normal(size=(2, 3, 5, 7)))
    for ring in (None, pmesh.Ring(1, 0, 0)):
        assert torch.equal(halo.halo_roll(x, shift, axis, ring), torch.roll(x, shift, axis))
    with pytest.raises(ValueError, match="shift"):
        halo.halo_roll(x, 2, axis, pmesh.Ring(2, 1, 1))


def test_halo_roll_gradient_one_shard():
    # HaloRoll's backward is the roll back; one shard: the exchange is local
    x = t(np.random.default_rng(1).normal(size=(3, 4, 5))).requires_grad_()
    ring = pmesh.Ring(1, 0, 0)
    assert torch.autograd.gradcheck(lambda v: halo.HaloRoll.apply(v, 1, -2, ring) * v, (x,))
    assert torch.autograd.gradcheck(lambda v: halo.HaloRoll.apply(v, -1, -1, ring).sin(), (x,))


@pytest.mark.parametrize("split", [(2, 2), (1, 4), (4, 1)])
def test_k2_halo_block_equals_whole_lattice(split):
    # K2's plain version on a block with its halo (pad, run, crop) equals the
    # whole lattice's result there, at the |rho| clamp too
    r = np.random.default_rng(2)
    C, L, M, N = 2, 2, 12, 16
    mu = t(r.uniform(-2, 2, (C, L, M, N)))
    sg = t(r.uniform(0.05, 3, (C, L, M, N)))
    rou = t(0.99999 * np.sign(r.uniform(-1, 1, (2, C, L, M, N))))
    alpha = t(np.array([0.3, 0.7]))
    T = t(np.array(0.2))
    args = (alpha, T, 13, 5.0, 1e-6, EDGE)
    whole = k2.edge_reduced_grads_torch(mu, sg, rou, *args)
    px, py = split
    ml, nl = M // px, N // py
    ms = torch.stack([mu, sg])
    for i in range(px):
        for j in range(py):
            blk = np.s_[..., i * ml:(i + 1) * ml, j * nl:(j + 1) * nl]
            down = ms[..., ((i + 1) * ml) % M:((i + 1) * ml) % M + 1, j * nl:(j + 1) * nl]
            right = ms[..., i * ml:(i + 1) * ml, ((j + 1) * nl) % N:((j + 1) * nl) % N + 1]
            got = k2.edge_reduced_grads(mu[blk].contiguous(), sg[blk].contiguous(),
                                        rou[blk].contiguous(), *args, halo=(down, right))
            for f, a, b in zip(got._fields, got, whole):
                np.testing.assert_allclose(a.numpy(), b[blk].numpy(), rtol=1e-12, atol=1e-12,
                                           err_msg=f"{f} block {(i, j)}")


@pytest.mark.parametrize("local_world,cards,on_cpu,want", [
    (1, 1, False, "nccl"), (4, 4, False, "nccl"), (2, 8, False, "nccl"),
    (4, 1, False, "gloo"), (2, 1, False, "gloo"), (4, 0, True, "gloo"), (1, 1, True, "gloo")])
def test_backend_rule(local_world, cards, on_cpu, want):
    # NCCL only where every rank of the host has a card of its own
    from gqmap_tpu_torch.parallel.launch import pick_backend

    assert pick_backend(local_world, cards, on_cpu) == want


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    from gqmap_tpu_torch.parallel import initialize

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize(device="cpu") == 1
    assert not torch.distributed.is_initialized()


def test_cli_run_devices_under_torchrun(tmp_path):
    # run --devices 2 under torch.distributed.run (2 gloo ranks on the CPU):
    # rank 0 alone prints the JSON line, and its AEPE is a one-process run's
    from _torch_common import write_sequence

    root = tmp_path / "data"
    write_sequence(root, "Venus", 32, 40, seed=0)
    args = ["run", "--seq", "Venus", "--preprocessed", "--preset", "tpu_fast", "--dtype",
            "float64", "--k", "3", "--l", "2", "--cheb-p", "12", "--cheb-q", "8",
            "--quad-chunk", "0", "--its", "6", "--eval-every", "3", "--quiet", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(GQMAP_DATA=str(root), OMP_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    def run(cmd):
        p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=repo, timeout=300)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        return [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]

    got = run([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "gqmap_tpu_torch.cli.main", *args,
               "--devices", "2"])
    want = run([sys.executable, "-m", "gqmap_tpu_torch.cli.main", *args])
    assert len(got) == 1 and len(want) == 1
    assert got[0]["iters"] == want[0]["iters"] == 6
    assert got[0]["best_aepe"] == pytest.approx(want[0]["best_aepe"], rel=0, abs=1e-8)
