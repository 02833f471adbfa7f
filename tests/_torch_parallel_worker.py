"""One rank of the port's multi-device solve on the CPU, for
``tests/test_torch_parallel.py``.

Run as ``python _torch_parallel_worker.py <rank> <world> <port> <dir>``: the
ranks form a gloo group on ``localhost:<port>``, read every case
``<dir>/in_<name>.npz`` in name order (the problem's and the state's
arrays, and a JSON ``meta``: the configuration, the mesh ``(dp, x, y)``, the
kind of run and the number of sweeps), run it on their blocks and write
``<dir>/out_<name>*.npz``. Imports nothing of JAX.

Kinds: ``sweep`` (``make_sharded_sweep`` ``n`` times from the state; the
whole state gathered after the last, with each sweep's energy and ptdmu),
``batched`` (``make_batched_sharded_sweep`` once on a batch of states split
over ``dp``; each ``dp`` index writes its own states) and ``solve``
(``solve(mesh=...)`` on every rank, each writing its result, then the same
solve broken by a checkpoint and resumed).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gqmap_tpu_torch import GQMAPConfig  # noqa: E402
from gqmap_tpu_torch.config import FlowRange  # noqa: E402
from gqmap_tpu_torch.convert import problem_from_numpy, state_from_numpy  # noqa: E402
from gqmap_tpu_torch.models.gqmap import GQState, solve  # noqa: E402
from gqmap_tpu_torch.parallel import (Mesh, gather_state, initialize,  # noqa: E402
                                      make_batched_sharded_sweep, make_sharded_sweep,
                                      shard_problem, shard_state)


def load(path):
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    arr = {k: z[k] for k in z.files if k != "meta"}
    return meta, arr


def problem_of(arr, data_term):
    cheb = None
    if "p_coeffs" in arr:
        cheb = {k: arr["p_" + k] for k in ("coeffs", "lo_u", "hi_u", "lo_v", "hi_v")}
    grad_tabs = (arr["p_grad0"], arr["p_grad1"]) if "p_grad0" in arr else None
    return problem_from_numpy(dict(I1=arr["p_I1"], I2_tab=arr["p_I2_tab"],
                                   interior=arr["p_interior"], rng=arr["p_rng"], cheb=cheb,
                                   init_flow=arr.get("p_init_flow"), grad_tabs=grad_tabs),
                             device="cpu", data_term=data_term)


def state_of(arr, prefix="s_"):
    return state_from_numpy({f: arr[prefix + f] for f in GQState._fields}, device="cpu")


def fields(st):
    return {f: getattr(st, f).numpy() for f in GQState._fields}


def run_case(name, meta, arr, mesh, out_dir):
    cfg = GQMAPConfig(**meta["cfg"])
    shape = tuple(meta["image_shape"])
    d, i, j = mesh.coords
    if meta["kind"] == "sweep":
        sweep = make_sharded_sweep(cfg, shape, mesh)
        problem = shard_problem(problem_of(arr, cfg.data_term), mesh)
        st = shard_state(state_of(arr), mesh)
        energy, ptdmu = [], []
        for _ in range(meta["n"]):
            st, aux = sweep(problem, st)
            energy.append(float(aux.energy))
            ptdmu.append(float(aux.ptdmu))
        st = gather_state(st, mesh)
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, f"out_{name}.npz"), energy=energy, ptdmu=ptdmu,
                     **fields(st))
    elif meta["kind"] == "batched":
        vsweep = make_batched_sharded_sweep(cfg, shape, mesh)
        problem = shard_problem(problem_of(arr, cfg.data_term), mesh)
        out, aux = vsweep(problem, shard_state(state_of(arr), mesh, batched=True))
        whole = [gather_state(GQState(*(x[b] for x in out)), mesh)
                 for b in range(out.muu.shape[0])]
        if (i, j) == (0, 0):
            for b, st in enumerate(whole):
                np.savez(os.path.join(out_dir, f"out_{name}_dp{d}_{b}.npz"),
                         energy=float(aux.energy[b]), **fields(st))
    elif meta["kind"] == "solve":
        kw = dict(gt_flow=arr["gt"], flow_range=FlowRange(*arr["p_rng"]), seed=3,
                  init=state_of(arr), mesh=mesh, device="cpu")
        I1, I2 = arr["I1"], arr["I2"]
        res = solve(cfg, I1, I2, **kw)
        np.savez(os.path.join(out_dir, f"out_{name}_r{mesh.rank}.npz"), AEPE=res.AEPE,
                 Energy=res.Energy, logP=res.logP, mu=res.mu, map=res.map)
        ck = os.path.join(out_dir, f"{name}.ckpt.npz")
        brk = cfg.its - cfg.eval_every  # at a readout, so the traces are an unbroken run's
        solve(GQMAPConfig(**{**meta["cfg"], "its": brk}), I1, I2, checkpoint_path=ck, **kw)
        res2 = solve(cfg, I1, I2, checkpoint_path=ck, resume=True, **kw)
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, f"out_{name}_resumed.npz"), AEPE=res2.AEPE,
                     Energy=res2.Energy, mu=res2.mu)
    else:
        raise ValueError(meta["kind"])


def main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    n = initialize(f"localhost:{port}", world, rank, device="cpu")
    if n != world:
        raise RuntimeError(f"world size {n}, expected {world}")
    names = sorted(f[3:-4] for f in os.listdir(out_dir) if f.startswith("in_"))
    for name in names:
        meta, arr = load(os.path.join(out_dir, f"in_{name}.npz"))
        mesh = Mesh(*meta["mesh"], rank=rank)
        run_case(name, meta, arr, mesh, out_dir)
        print(f"rank {rank}: {name} done", flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
