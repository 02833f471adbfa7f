"""Checkpoint / exact resume of the solver state (port of
``gqmap_tpu/utils/checkpoint.py``).

The file is the JAX package's: an ``.npz`` with one array per ``GQState``
field, the configuration as JSON bytes under ``__config__`` and each extra
under ``extra_<name>``. The two packages' configurations are field for field
the same, so a checkpoint written by one loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import GQMAPConfig
from ..models.gqmap import GQState, _device

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path, state: GQState, cfg: GQMAPConfig | None = None, **extra):
    """Atomically write the solver state (and optional config) to ``path``."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f: getattr(state, f).cpu().numpy() for f in state._fields}
    if cfg is not None:
        payload["__config__"] = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(),
                                              dtype=np.uint8)
    for k, v in extra.items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path, expect_cfg: GQMAPConfig | None = None, device=None):
    """Load ``(state, cfg_or_None, extras)`` with the state on ``device``
    (default the GPU); verifies the config match if ``expect_cfg`` is given.

    ``its`` is excluded from the match: resuming under a longer or shorter
    sweep budget changes no per-sweep semantics.
    """
    device = _device(device)
    with np.load(os.fspath(path)) as z:
        cfg = None
        if "__config__" in z:
            cfg = GQMAPConfig(**json.loads(bytes(z["__config__"]).decode()))
        if (expect_cfg is not None and cfg is not None
                and dataclasses.replace(cfg, its=expect_cfg.its) != expect_cfg):
            raise ValueError("checkpoint config does not match the requested run")
        state = GQState(**{f: torch.as_tensor(z[f], device=device) for f in GQState._fields})
        extras = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return state, cfg, extras
