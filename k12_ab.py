"""Time kernel K12's variants in turns on one card, and what its per-tap fallback costs.

    python k12_ab.py [--sweeps 0,10,100,300]

On the synthetic 376x452 pair of ``chip_smoke.py`` in float32, for
``full_mixture(window_rg=2)`` ((3, 376, 452) sites) and
``legacy_v2(data_term="bicubic")`` ((1, 376, 452)), K12 is timed by
``kernels/roofline.kernel_ms`` in turns: v2, v1, v2 without its per-tap
fallback, v2 again. The states are ``chip_smoke.k4_probes``' three (the
init, sigma = 0.05 with the means drawn over the flow box, the |rho|
clamp) and the solve's own after each sweep count (its segment runner,
tor = 0, from ``init_state``). "v2 without its fallback" is compiled from a
copy of ``csrc/node_gq.cu`` whose v2 per-tap fallback returns 0 (its sums
are wrong and are not used): v2's time less its time is what the fallback
costs. Beside each state the shares of points and of warp rounds that take
the fallback (``chip_smoke.border_fails``). Prints one line a state and, as
its last line, a JSON object of every number. Needs a Hopper card and
``nvcc``; the copy builds into ``gqmap_tpu_torch/_build``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess

import torch

import chip_smoke as cs
from gqmap_tpu_torch import FlowRange, GQMAPConfig
from gqmap_tpu_torch.kernels import build, roofline, window_gq
from gqmap_tpu_torch.models import gqmap as pg

FALLBACK_CALL = "F = window_pixels_v2<T, P, R>("  # v2's per-tap fallback in window_points_v2


def library_without_fallback() -> ctypes.CDLL:
    """The kernels of ``csrc/node_gq.cu`` with v2's per-tap fallback
    replaced by F = 0, built and loaded with the entry points' argtypes."""
    with open(os.path.join(build.CSRC, "node_gq.cu")) as f:
        src = f.read()
    if src.count(FALLBACK_CALL) != 1:
        raise RuntimeError(f"k12_ab: {FALLBACK_CALL!r} is not once in csrc/node_gq.cu")
    i = src.index(FALLBACK_CALL)
    src = src[:i] + "F = T(0);" + src[src.index(";", i) + 1:]
    out = os.path.join(build.BUILD_DIR, "k12_ab")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "node_gq_no_fallback.cu"), os.path.join(out, "libno_fallback.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build._find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, cu],
                   check=True, capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(so)
    for name, args in build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", default="0,10,100,300")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k12_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    sweeps = sorted(int(s) for s in a.sweeps.split(","))
    build.load_library()
    stub = library_without_fallback()
    own = build.library_for
    I1, I2, _ = cs.synthetic_pair()
    fr = FlowRange(*cs.FR)
    card = cs.smi("name,power.limit")
    print(card, flush=True)

    def turns(args):
        """K12's times on ``args`` in turns: v2, v1, v2 without its
        fallback, v2 again."""
        ms = {}
        for turn in ("v2", "v1", "v2 without fallback", "v2 again"):
            if turn == "v2 without fallback":
                build.library_for = lambda device: stub
            try:
                ms[turn] = roofline.kernel_ms(lambda: window_gq.node_window_gq_cuda(
                    *args, variant="v1" if turn == "v1" else "v2"))[0]
            finally:
                build.library_for = own
        return ms

    out = dict(card=card)
    for name, cfg in (("full_mixture window_rg=2", GQMAPConfig.full_mixture(window_rg=2)),
                      ("legacy_v2 bicubic", GQMAPConfig.legacy_v2(data_term="bicubic"))):
        problem = pg.make_problem(cfg, I1, I2, fr, dev)
        states = [(f"probe {k}", st) for k, st in cs.k4_probes(cfg, (cs.H, cs.W), dev).items()]
        st = pg.init_state(cfg, fr, (cs.H, cs.W), seed=0, device=dev)
        seg = pg.make_segment_runner(dataclasses.replace(cfg, tor=0.0), (cs.H, cs.W))
        done = 0
        for n in sweeps:
            if n > done:
                st = seg(problem, st, n - done)[0]
                done = n
            states.append((f"solve after {n} sweeps", st))
        for label, st in states:
            sites = [x.float().contiguous() for x in (st.muu, st.muv, st.sigmau, st.sigmav,
                                                      st.pn)]
            args = (problem.I1, problem.I2_tab, *sites, cfg.K, cfg.lambdad, cfg.epsn,
                    cfg.window_rg)
            ms = turns(args)
            v2 = (ms["v2"] + ms["v2 again"]) / 2
            rec = out.setdefault(name, {})[label] = dict(
                ms=ms, fallback_ms=v2 - ms["v2 without fallback"],
                fallback_share=(v2 - ms["v2 without fallback"]) / v2,
                border=cs.border_fails(st, cfg.K, cfg.window_rg, (cs.H, cs.W)),
                sigma_median=float(st.sigmau.float().median()))
            print(f"{name}, {label}: ms {ms}; v2's fallback {rec['fallback_ms']:.4f} ms "
                  f"({rec['fallback_share']:.1%}); border shares {rec['border']}; median "
                  f"sigma_u {rec['sigma_median']:.4f}", flush=True)
        del problem, seg
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
