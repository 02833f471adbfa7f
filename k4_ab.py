"""Time kernel K4's two variants on the states a solve passes through, on one card.

    python k4_ab.py [--sweeps 0,3,10,30,100,300,1000]

For ``full_mixture`` (K = 9), ``super_entropy`` (K = 11, patch 4) and
``ctf_level`` (K = 11, L = 1) on the synthetic 376x452 pair of
``chip_smoke.py`` in float32, the solve's segment runner (tor = 0) is
advanced from ``init_state`` to each sweep count, and at each state K4 is
timed by ``kernels/roofline.kernel_ms`` in turns: v1, v2, v2, v1 (the
median of each variant's two is printed), with v2's shares of CTAs that
have no shared-memory window and of sites read through L1, and the state's
median sigmas. The phase 6b probes of ``chip_smoke.py`` draw the means
uniformly over the flow box; these states are the solver's own. Prints one
line a state and, as its last line, a JSON object of every time. Needs a
Hopper card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

import chip_smoke as cs
from gqmap_tpu_torch import FlowRange, GQMAPConfig
from gqmap_tpu_torch.kernels import node_gq, roofline
from gqmap_tpu_torch.models import gqmap as pg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", default="0,3,10,30,100,300,1000")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    sweeps = sorted(int(s) for s in a.sweeps.split(","))
    I1, I2, _ = cs.synthetic_pair()
    fr = FlowRange(*cs.FR)
    print(cs.smi("name,power.limit"), flush=True)
    out = {}
    for name, cfg in (("full_mixture", GQMAPConfig.full_mixture()),
                      ("super_entropy", GQMAPConfig.super_entropy()),
                      ("ctf_level", GQMAPConfig.ctf_level())):
        problem = pg.make_problem(cfg, I1, I2, fr, dev)
        st = pg.init_state(cfg, fr, (cs.H, cs.W), seed=0, device=dev)
        seg = pg.make_segment_runner(dataclasses.replace(cfg, tor=0.0), (cs.H, cs.W))
        done = 0
        for n in sweeps:
            if n > done:
                st = seg(problem, st, n - done)[0]
                done = n
            args = (problem.I1, problem.I2_tab, st.muu, st.muv, st.sigmau, st.sigmav, st.pn,
                    cfg.K, cfg.lambdad, cfg.epsn)
            cnt = torch.zeros(2, dtype=torch.int64, device=dev)
            node_gq.node_gq_cuda(*args, patch=cfg.patch, variant="v2", l1_counts=cnt)
            ms = {"v1": [], "v2": []}
            for v in ("v1", "v2", "v2", "v1"):
                ms[v].append(roofline.kernel_ms(
                    lambda: node_gq.node_gq_cuda(*args, patch=cfg.patch, variant=v))[0])
            rec = out[f"{name} after {n}"] = dict(
                v1_ms=sorted(ms["v1"])[0] / 2 + sorted(ms["v1"])[1] / 2,
                v2_ms=sorted(ms["v2"])[0] / 2 + sorted(ms["v2"])[1] / 2,
                l1_ctas=int(cnt[0]) / node_gq.v2_ctas(tuple(st.muu.shape), cfg.patch),
                l1_sites=int(cnt[1]) / st.muu.numel(),
                sigma_median=[float(st.sigmau.median()), float(st.sigmav.median())])
            print(f"{name} after {n} sweeps: sigma median {rec['sigma_median'][0]:.3f}, "
                  f"{rec['sigma_median'][1]:.3f}; K4 v1 {rec['v1_ms']:.4f} ms, v2 "
                  f"{rec['v2_ms']:.4f} ms; v2's CTAs without a window {rec['l1_ctas']:.3f}, "
                  f"sites through L1 {rec['l1_sites']:.3f}", flush=True)
        del seg
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
