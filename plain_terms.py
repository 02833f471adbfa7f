"""Time what the port still sums in plain torch, on one card.

    python plain_terms.py

On the synthetic 376x452 pair of ``chip_smoke.py`` in float32: for each
configuration of :data:`TERMS`, one whose node or edge term no kernel of the
port computed before the autodiff estimator's kernels K13-K16 (the autodiff
configurations of ``tpu_fast``, ``full_mixture`` and ``legacy_v2`` run K13-K15
with K1 and K6; the windowed and super-lattice bicubic ones K16 and K13 at
patch 4), the ms a sweep of a :data:`SWEEPS`-sweep graph segment
(``make_segment_runner``, tor = 0) from the init state with every sigma at
0.05, timed by CUDA events after the capture, with the capture's time and
the peak device memory above what was held before the problem was made. A
term that runs out of the card's memory is recorded as that: the error, its
lattice and the bytes the failed allocation asked for. Then one logP readout (``make_logp_fn``: the bicubic point potential and
the Charbonnier edges at the MAP) of ``tpu_fast`` and of ``legacy_v2``,
the mean of 5 calls after one (``chip_smoke.time_ms``). Prints the card's
name and power limit, one line a term, and, as its last line, a JSON object
of every number. Exits with 1 if a segment ran off the graph route or a
readout was not finite. Needs a Hopper card.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time

import torch

import chip_smoke as cs
from gqmap_tpu_torch import FlowRange, GQMAPConfig
from gqmap_tpu_torch.models import gqmap as pg

AD = dict(gradient_estimator="autodiff")
TERMS = {  # ROADMAP Queue 1 (the windowed bicubic term runs through kernel K12)
    "full_mixture chebyshev cheb_q=96": GQMAPConfig.full_mixture(data_term="chebyshev",
                                                                 cheb_q=96, quad_chunk=27),
    "legacy_v2 autodiff": GQMAPConfig.legacy_v2(**AD),
    "tpu_fast autodiff": GQMAPConfig.tpu_fast(**AD),
    "full_mixture autodiff": GQMAPConfig.full_mixture(**AD),
    "legacy_v1 edge_quad=reduced": GQMAPConfig.legacy_v1(quad_var=0.05, edge_quad="reduced"),
    # the autodiff estimator's other node terms
    "full_mixture window_rg=2 autodiff": GQMAPConfig.full_mixture(window_rg=2, **AD),
    "legacy_v2 bicubic autodiff": GQMAPConfig.legacy_v2(data_term="bicubic", **AD),
    "super_entropy autodiff": GQMAPConfig.super_entropy(**AD),
    "full_mixture chebyshev autodiff": GQMAPConfig.full_mixture(data_term="chebyshev", **AD),
    "legacy_v1 autodiff": GQMAPConfig.legacy_v1(quad_var=0.05, **AD),
    "legacy_v1 edge_quad=reduced autodiff": GQMAPConfig.legacy_v1(quad_var=0.05,
                                                                  edge_quad="reduced", **AD),
}
SWEEPS = 30


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("plain_terms: no CUDA device")
    dev = torch.device("cuda", 0)
    fr = FlowRange(*cs.FR)
    pair = cs.synthetic_pair()
    out = {"card": cs.smi("name,power.limit")}
    print(out["card"], flush=True)
    ok = True
    for name, base in TERMS.items():
        cfg = dataclasses.replace(base, its=100000, eval_every=SWEEPS, tor=0.0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        problem = cs.update_problem(pg, cfg, fr, dev, pair)
        st = pg.init_state(cfg, fr, (cs.H, cs.W), seed=0, device=dev)
        st = st._replace(sigmau=torch.full_like(st.sigmau, 0.05),
                         sigmav=torch.full_like(st.sigmav, 0.05))
        seg = pg.make_segment_runner(cfg, (cs.H, cs.W))
        t = time.time()
        try:
            seg(problem, st, 3)  # the capture
        except torch.cuda.OutOfMemoryError as err:  # a finding, not a failure
            asked = re.search(r"Tried to allocate ([0-9.]+ [KMGT]iB)", str(err))
            out[name] = dict(out_of_memory=str(err).splitlines()[0],
                             lattice=list(st.muu.shape), bytes_asked=asked and asked.group(1),
                             GiB_at_the_error=(torch.cuda.max_memory_allocated() - held) / 2**30)
            print(f"{name}: out of the card's memory on the {tuple(st.muu.shape)} lattice, "
                  f"asking for {out[name]['bytes_asked']} at a peak of "
                  f"{out[name]['GiB_at_the_error']:.3f} GiB above held: "
                  f"{out[name]['out_of_memory']}", flush=True)
            del seg, problem, st
            torch.cuda.empty_cache()
            continue
        capture_s = time.time() - t
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        done = seg(problem, st, SWEEPS)[1]
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / SWEEPS
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        ok &= done == SWEEPS and seg.route == "graph"
        out[name] = dict(ms_a_sweep=ms, capture_s=capture_s, GiB_above_held=peak,
                         sweeps=done, route=seg.route)
        print(f"{name}: {ms:.4f} ms a sweep ({done} sweeps on route {seg.route!r}, from sigma "
              f"0.05), capture and first sweeps {capture_s:.2f} s, peak {peak:.3f} GiB above "
              "held (problem included)", flush=True)
        del seg, problem, st
    for name, cfg in (("tpu_fast", GQMAPConfig.tpu_fast()),
                      ("legacy_v2", GQMAPConfig.legacy_v2())):
        problem = pg.make_problem(cfg, *pair[:2], fr, dev)
        st = pg.init_state(cfg, fr, (cs.H, cs.W), seed=0, device=dev)
        logp = pg.make_logp_fn(cfg, (cs.H, cs.W))
        flow = pg.make_map_fn(cfg)(st)
        ms = cs.time_ms(lambda: logp(problem, flow), 5)
        finite = bool(torch.isfinite(logp(problem, flow)))
        ok &= finite
        out[f"logP readout {name}"] = dict(ms=ms, finite=finite)
        print(f"one logP readout of {name} at 376x452: {ms:.4f} ms (finite: {finite})",
              flush=True)
        del problem
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
