"""Middlebury ``.flo`` reader/writer.

Binary format (little-endian): float32 tag 202021.25 ('PIEH'), int32 width,
int32 height, then row-major interleaved float32 (u, v) pairs. Parity specs:
``readFlowFile.m:56-81`` and ``legacy/writeFlowFile.m:57-76``.

A copy of ``gqmap_tpu/io/flo.py`` (numpy and struct): the port cannot import
the JAX package, whose ``__init__`` imports JAX.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["read_flo", "write_flo", "TAG_FLOAT", "TAG_STRING"]

TAG_FLOAT = 202021.25
TAG_STRING = b"PIEH"


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Read a ``.flo`` file into an (H, W, 2) float32 array."""
    path = os.fspath(path)
    if not path.endswith(".flo"):
        raise ValueError(f"read_flo: {path!r} should have extension '.flo'")
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) != 12:
            raise ValueError(f"read_flo({path}): truncated header")
        tag, width, height = struct.unpack("<fii", header)
        if tag != TAG_FLOAT:
            raise ValueError(
                f"read_flo({path}): wrong tag {tag} (big-endian file?)"
            )
        if not (1 <= width <= 99999):
            raise ValueError(f"read_flo({path}): illegal width {width}")
        if not (1 <= height <= 99999):
            raise ValueError(f"read_flo({path}): illegal height {height}")
        data = np.fromfile(f, dtype="<f4", count=height * width * 2)
    if data.size != height * width * 2:
        raise ValueError(f"read_flo({path}): truncated data")
    return data.reshape(height, width, 2)


def write_flo(path: str | os.PathLike, flow: np.ndarray) -> None:
    """Write an (H, W, 2) array as a ``.flo`` file."""
    path = os.fspath(path)
    if not path.endswith(".flo"):
        raise ValueError(f"write_flo: {path!r} should have extension '.flo'")
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("write_flo: flow must have two bands")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(TAG_STRING)
        f.write(struct.pack("<ii", w, h))
        flow.astype("<f4").tofile(f)
