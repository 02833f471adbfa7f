"""Throughput of the port's flagship sweep on one card.

    python -m gqmap_tpu_torch.cli.main bench [--device cpu]

The port's counterpart of the root ``bench.py`` (the JAX package's, which
stays as it is). Prints ONE JSON line with that script's keys:
``metric``, ``value``, ``unit``, ``vs_baseline``, ``mode``,
``steady_state`` and ``from_init``, and ``device``, the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (``"cpu"`` for a CPU run).

``value`` is the converged rate (sigma pinned at 0.05, where ~95% of a
30000-sweep solve runs), ``from_init`` the same from the random init, both
in Mpixel-sweeps/s: one 300-sweep segment of ``make_segment_runner`` (the
way ``solve`` runs: on the card its graph route, whose capture the 10-sweep
warm segment before it takes) timed by the host clock from a
``torch.cuda.synchronize()`` to the next, so it is the wall time a user
sees, host included. ``vs_baseline`` is 1.0: the repository's only
earlier records are TPU ones, and they are no baseline for a card.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

__all__ = ["load_problem_images", "measure", "main"]

METRIC = "gqmap_torch_converged_sweep_throughput"
WARM, SEG_LEN = 10, 300  # sweeps of the warm and of the timed segment


def load_problem_images():
    """Teddy (``io.dataset.load_sequence``) where ``GQMAP_DATA`` holds it and
    it loads, else, on any exception (no data, or no ``imageio`` for its PNG
    frames), the synthetic 376x452 pair of the root ``bench.py``: smoothed
    noise and its one-pixel roll. Says on stderr which frames it took and,
    for the synthetic pair, why."""
    from .config import FlowRange
    from .io.dataset import load_sequence
    from .ops.flowviz import flow_to_color

    try:
        seq = load_sequence("Teddy")
    except Exception as e:  # the root bench.py's rule, without its retries
        print(f"bench: {type(e).__name__}: {e}; using the synthetic 376x452 pair",
              file=sys.stderr)
        r = np.random.default_rng(0)
        I1 = r.uniform(0, 255, (376, 452))
        k = np.ones(5) / 5
        I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, I1)
        I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, I1)
        return I1, np.roll(I1, 1, axis=1), FlowRange(-10.0, 2.0, -2.0, 2.0)
    print(f"bench: Teddy frame10/frame11, {seq.img1.shape[0]}x{seq.img1.shape[1]}",
          file=sys.stderr)
    fc = flow_to_color(seq.gt_flow)
    return seq.img1, seq.img2, FlowRange(fc.minu, fc.maxu, fc.minv, fc.maxv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(data_term: str, warm: int = WARM, seg_len: int = SEG_LEN, steady: bool = False,
            device=None) -> float:
    """Mpixel-sweeps/s of one ``seg_len``-sweep segment of
    ``full_mixture(float32, quad_chunk=27, cheb_p=64, cheb_q=16,
    edge_quad="reduced")`` with ``data_term`` (``"cosine"`` is ``tpu_fast``)
    after a ``warm``-sweep segment; from the random init, or with
    ``steady`` from sigma = 0.05."""
    from .config import GQMAPConfig
    from .models.gqmap import _device, init_state, make_problem, make_segment_runner

    dev = _device(device)
    I1, I2, fr = load_problem_images()
    cfg = GQMAPConfig.full_mixture(dtype="float32", quad_chunk=27, data_term=data_term,
                                   cheb_p=64, cheb_q=16, edge_quad="reduced",
                                   eval_every=seg_len, tor=0.0)
    problem = make_problem(cfg, I1, I2, fr, dev)
    state = init_state(cfg, fr, np.shape(I1), device=dev)
    if steady:
        state = state._replace(sigmau=torch.full_like(state.sigmau, 0.05),
                               sigmav=torch.full_like(state.sigmav, 0.05))
    seg = make_segment_runner(cfg, np.shape(I1))
    state, *_ = seg(problem, state, warm)
    _sync(dev)
    t0 = time.perf_counter()
    state, n, *_ = seg(problem, state, seg_len)
    _sync(dev)
    dt = (time.perf_counter() - t0) / seg_len
    if n != seg_len:
        raise RuntimeError(f"the timed segment ran {n} sweeps of {seg_len}")
    return np.size(I1) / dt / 1e6


def main(device=None) -> None:
    """Measure the flagship ``cosine`` term from init and converged on
    ``device`` (the GPU by default) and print the JSON line."""
    from .kernels.roofline import card_line
    from .models.gqmap import _device

    dev = _device(device)
    from_init = measure("cosine", WARM, SEG_LEN, device=dev)
    steady = measure("cosine", WARM, SEG_LEN, steady=True, device=dev)
    print(json.dumps({
        "metric": METRIC,
        "value": steady,
        "unit": "Mpixel-sweeps/s/card" if dev.type == "cuda" else "Mpixel-sweeps/s/cpu",
        "vs_baseline": 1.0,
        "mode": "cosine",
        "steady_state": steady,
        "from_init": from_init,
        "device": card_line(dev),
    }))


if __name__ == "__main__":
    main()
