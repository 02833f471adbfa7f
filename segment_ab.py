"""Time the port's host-bound sweep paths in two checkouts, in turns, on one card.

    python segment_ab.py OLD_ROOT NEW_ROOT [--rounds 2]

Each root is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
and ``.``). The roots run in the order old, new, new, old, once a round, each
in a process of its own that imports ``gqmap_tpu_torch`` from its root, so
that the card's and the host's drift over the call falls on both alike. Each
process times, on the synthetic 376x452 pair of ``chip_smoke.py`` in float32:

* ``tpu_fast``: a 300-sweep segment from the random init and one from a
  converged state (sigma 0.05), after 10 sweeps of warm-up (CUDA events);
* ``tpu_fast`` red-black: a 100-sweep segment;
* 50 ``tpu_fast`` sweeps without the segment's per-sweep flag read: the
  host's time to enqueue them and the time until the card has run them;
* ``full_mixture`` (``quad_chunk=27``, the exact path: kernels K4 and K3):
  10 sweeps from the random init, after 2 of warm-up (CUDA events),
  device-bound where the others are host-bound;
* the K4 paths (``full_mixture``, ``super_entropy``, ``ctf_level``): a
  100-sweep graph segment from a converged state (sigma 0.05);
* ``k4_sums_sha256``: a digest of kernel K4's sums, both variants, on the
  init and converged states of those three paths in float32 and float64:
  equal digests mean the two checkouts' K4 sums are equal bit for bit;
  ``k3_sums_sha256`` the same of kernel K3's (the rule's own instance and
  the generic one), and ``k10_k11_v1_sums_sha256`` of K10's and K11's v1
  (a checkout without ``variant`` runs only v1) at K = 9, both instances,
  on those states with the state's means as the quadratic prior;
  ``k12_sums_sha256`` of kernel K12's, both variants, at rg = 2 on the
  one-pixel lattices' states (``full_mixture``, ``ctf_level``),
  ``k13_k14_sums_sha256`` of kernels K13's (those lattices) and K14's (every
  state) and ``k15_sums_sha256`` of kernel K15's five outputs (every state,
  K1 = 21, 25 and 13) under each checkout's default variant: equal digests
  of a parent whose default is v1 and a tree whose default is v2 mean v2's
  sums are v1's bit for bit; ``k16_sums_sha256`` of kernel K16's (rg = 2,
  the one-pixel lattices' states) and ``k13_patch4_sums_sha256`` of K13's
  at patch 4 (``super_entropy``'s), None in a checkout without them;
* the autodiff paths through K16 (``full_mixture(window_rg=2)``,
  ``legacy_v2(data_term="bicubic")``) and K13 at patch 4
  (``super_entropy``): a 30-sweep graph segment from a converged state and
  a digest of the state 10 sweeps on (None in a checkout without those
  kernels);
* the torch operators one ``tpu_fast``, one red-black and one
  ``full_mixture`` sweep dispatch (the kernels themselves, launched through
  ``ctypes``, are not among them): equal counts mean the same glue work on
  the card and the host.

Each time is the median of 3 repeats within the process. Prints one line a
process, then, as its last line, a JSON summary (each metric's values by
root, in run order). Needs a Hopper card; the kernels build into each
root's own ``gqmap_tpu_torch/_build``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

H, W = 376, 452
FR = (-10.0, 2.0, -2.0, 2.0)


def synthetic_pair():
    """The pair of ``chip_smoke.py``: smoothed noise, frame 2 shifted one pixel."""
    import numpy as np

    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (H, W))
    k = np.ones(5) / 5
    I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, I1)
    I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, I1)
    return I1, np.roll(I1, 1, axis=1)


def one(root: str) -> dict:
    """Every timing of one checkout, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import gqmap_tpu_torch
    from gqmap_tpu_torch import FlowRange, GQMAPConfig
    from gqmap_tpu_torch.models import gqmap as pg

    where = os.path.dirname(os.path.dirname(os.path.abspath(gqmap_tpu_torch.__file__)))
    if where != os.path.abspath(root):
        raise SystemExit(f"imported gqmap_tpu_torch from {where}, not {root}")
    dev = torch.device("cuda", 0)
    I1, I2 = synthetic_pair()
    fr = FlowRange(*FR)
    cfg = GQMAPConfig.tpu_fast(its=900, eval_every=300, tor=0.0)
    problem = pg.make_problem(cfg, I1, I2, fr, dev)
    st0 = pg.init_state(cfg, fr, (H, W), seed=0, device=dev)
    conv = st0._replace(sigmau=torch.full_like(st0.sigmau, 0.05),
                        sigmav=torch.full_like(st0.sigmav, 0.05))

    def segment_ms(c, st, n, problem=problem):
        seg = pg.make_segment_runner(c, (H, W))
        st, *_ = seg(problem, st, 10)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            done = seg(problem, st, n)[1]
            t1.record()
            torch.cuda.synchronize()
            if done != n:
                raise SystemExit(f"segment ran {done} sweeps ({n} asked)")
            times.append(t0.elapsed_time(t1) / n)
        return float(np.median(times))

    out = dict(root=root, tpu_fast_from_init_ms=segment_ms(cfg, st0, 300),
               tpu_fast_converged_ms=segment_ms(cfg, conv, 300),
               redblack_ms=segment_ms(dataclasses.replace(cfg, sweep_order="redblack"), st0, 100))
    sweep = pg.make_sweep(cfg, (H, W))
    host, card = [], []
    for _ in range(3):
        st = st0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            st, _ = sweep(problem, st)
        host.append((time.perf_counter() - t) / 50 * 1e3)
        torch.cuda.synchronize()
        card.append((time.perf_counter() - t) / 50 * 1e3)
    out.update(host_enqueue_ms=float(np.median(host)), card_done_ms=float(np.median(card)))
    fm = GQMAPConfig.full_mixture(quad_chunk=27)
    fprob = pg.make_problem(fm, I1, I2, fr, dev)
    fsweep = pg.make_sweep(fm, (H, W))
    st = fsweep(fprob, fsweep(fprob, st0)[0])[0]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        s = st0
        for _ in range(10):
            s, _ = fsweep(fprob, s)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / 10)
    out["full_mixture_ms"] = float(np.median(times))
    from gqmap_tpu_torch.kernels import node_gq
    from gqmap_tpu_torch.ops.interp import pad_cubic

    import inspect

    from gqmap_tpu_torch.kernels import autodiff_gq, edge_gq, edge_reduced_gq, quad_gq, window_gq

    v1 = ({"variant": "v1"} if "variant" in inspect.signature(
        quad_gq.quad_node_gq_cuda).parameters else {})
    digest, d3, d10 = hashlib.sha256(), hashlib.sha256(), hashlib.sha256()
    d12, d13, d15 = hashlib.sha256(), hashlib.sha256(), hashlib.sha256()
    d16, d13p = hashlib.sha256(), hashlib.sha256()
    # K16 and K13 at patch 4, where the checkout has them
    has16 = hasattr(autodiff_gq, "node_window_chain_gq_cuda")
    has13p = "patch" in inspect.signature(autodiff_gq.node_chain_gq_cuda).parameters
    for name, c in (("full_mixture", fm), ("super_entropy", GQMAPConfig.super_entropy()),
                    ("ctf_level", GQMAPConfig.ctf_level())):
        c = dataclasses.replace(c, tor=0.0)
        s0 = pg.init_state(c, fr, (H, W), seed=0, device=dev)
        sc = s0._replace(sigmau=torch.full_like(s0.sigmau, 0.05),
                         sigmav=torch.full_like(s0.sigmav, 0.05))
        out[f"{name}_graph_converged_ms"] = segment_ms(c, sc, 100,
                                                       pg.make_problem(c, I1, I2, fr, dev))
        for s in (s0, sc):
            for dtype in (torch.float32, torch.float64):
                I1d = torch.as_tensor(I1, dtype=dtype, device=dev)
                VVd = pad_cubic(torch.as_tensor(I2, dtype=dtype, device=dev))
                fields = [x.to(dtype).contiguous() for x in (s.muu, s.muv, s.sigmau, s.sigmav,
                                                              s.pn)]
                for variant in node_gq.VARIANTS:
                    got = node_gq.node_gq_cuda(I1d, VVd, *fields, c.K, c.lambdad, c.epsn,
                                               patch=c.patch, variant=variant)
                    digest.update(torch.stack(got).cpu().numpy().tobytes())
                if c.patch == 1:
                    for variant in window_gq.VARIANTS:
                        got = window_gq.node_window_gq_cuda(I1d, VVd, *fields, c.K, c.lambdad,
                                                            c.epsn, 2, variant=variant)
                        d12.update(torch.stack(got).cpu().numpy().tobytes())
                    got = autodiff_gq.node_chain_gq_cuda(I1d, VVd, *fields, c.K, c.lambdad,
                                                         c.epsn)
                    d13.update(torch.stack(got).cpu().numpy().tobytes())
                    if has16:
                        got = autodiff_gq.node_window_chain_gq_cuda(I1d, VVd, *fields, c.K,
                                                                    c.lambdad, c.epsn, 2)
                        d16.update(torch.stack(got).cpu().numpy().tobytes())
                elif has13p:
                    got = autodiff_gq.node_chain_gq_cuda(I1d, VVd, *fields, c.K, c.lambdad,
                                                         c.epsn, patch=c.patch)
                    d13p.update(torch.stack(got).cpu().numpy().tobytes())
                mu, sg = torch.stack(fields[:2]), torch.stack(fields[2:4])
                edge = (mu, sg, *edge_reduced_gq.neighbour_stacks(mu, sg),
                        s.rou.to(dtype).contiguous())
                got = autodiff_gq.edge_chain_gq_cuda(*edge, c.K, c.lambdas, c.epsn)
                d13.update(torch.stack(got).cpu().numpy().tobytes())
                for k1 in (21, 25, 13):
                    got = autodiff_gq.edge_diff_adjoint_cuda(mu, sg, edge[4], k1, c.lambdas,
                                                             c.epsn)
                    d15.update(torch.stack(got).cpu().numpy().tobytes())
                prior = torch.stack(fields[:2], -1)[0]
                for generic in (False, True):
                    got = edge_gq.edge_gq_cuda(*edge, c.K, c.lambdas, c.epsn, generic=generic)
                    d3.update(torch.stack(got).cpu().numpy().tobytes())
                    got = quad_gq.quad_node_gq_cuda(prior, *fields, 9, 0.05, generic=generic,
                                                    **v1)
                    d10.update(torch.stack(got).cpu().numpy().tobytes())
                    got = quad_gq.truncquad_edge_gq_cuda(*edge, 9, 1.0, 10.0, generic=generic,
                                                         **v1)
                    d10.update(torch.stack(got).cpu().numpy().tobytes())
    out["k4_sums_sha256"] = digest.hexdigest()
    out["k3_sums_sha256"] = d3.hexdigest()
    out["k10_k11_v1_sums_sha256"] = d10.hexdigest()
    out["k12_sums_sha256"] = d12.hexdigest()
    out["k13_k14_sums_sha256"] = d13.hexdigest()
    out["k15_sums_sha256"] = d15.hexdigest()
    out["k16_sums_sha256"] = d16.hexdigest() if has16 else None
    out["k13_patch4_sums_sha256"] = d13p.hexdigest() if has13p else None
    # the autodiff paths through K16 and K13 at patch 4: a 30-sweep graph
    # segment from sigma = 0.05, and a digest of the state 10 sweeps on
    for name, c, has in (
            ("full_mixture_window_autodiff", GQMAPConfig.full_mixture(
                window_rg=2, gradient_estimator="autodiff", tor=0.0), has16),
            ("legacy_v2_bicubic_autodiff", GQMAPConfig.legacy_v2(
                data_term="bicubic", gradient_estimator="autodiff", tor=0.0), has16),
            ("super_entropy_autodiff", GQMAPConfig.super_entropy(
                gradient_estimator="autodiff", tor=0.0), has13p)):
        if not has:  # their plain route runs out of memory or takes seconds a segment
            out[f"{name}_graph_converged_ms"] = out[f"{name}_state_sha256"] = None
            continue
        c = dataclasses.replace(c, its=100000)
        prob = pg.make_problem(c, I1, I2, fr, dev)
        s0 = pg.init_state(c, fr, (H, W), seed=0, device=dev)
        sc = s0._replace(sigmau=torch.full_like(s0.sigmau, 0.05),
                         sigmav=torch.full_like(s0.sigmav, 0.05))
        out[f"{name}_graph_converged_ms"] = segment_ms(c, sc, 30, prob)
        end = pg.make_segment_runner(c, (H, W))(prob, sc, 10)[0]
        out[f"{name}_state_sha256"] = hashlib.sha256(b"".join(
            x.cpu().numpy().tobytes() for x in end)).hexdigest()
    for name, sw, prob in (
            ("tpu_fast", pg.make_sweep(cfg, (H, W)), problem),
            ("redblack", pg.make_sweep(dataclasses.replace(cfg, sweep_order="redblack"), (H, W)),
             problem),
            ("full_mixture", fsweep, fprob)):
        with _op_count_mode() as count:
            sw(prob, st0)
        out[f"{name}_ops_per_sweep"] = count.n
    return out


def _op_count_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        """Counts the torch operators dispatched inside it."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return OpCount()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return
    if len(args.roots) != 2:
        ap.error("give two roots: OLD_ROOT NEW_ROOT")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("segment_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    old, new = args.roots
    runs = []
    for _ in range(args.rounds):
        for root in (old, new, new, old):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                               capture_output=True, text=True, timeout=1200)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"segment_ab: the run of {root} failed ({p.returncode})")
            runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    metrics = [k for k in runs[0] if k != "root"]
    summary = dict(card=card, order=[r["root"] for r in runs],
                   by_root={root: {m: [r[m] for r in runs if r["root"] == root] for m in metrics}
                            for root in (old, new)})
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
