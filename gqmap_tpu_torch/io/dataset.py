"""Middlebury dataset registry.

Port of ``gqmap_tpu/io/dataset.py``. The reference bundles 10 sequences
under ``middlebury/<Seq>/`` with ``frame10.png``, ``frame11.png`` and (for
8 of them) dense ground truth ``flow10.flo``. The data root is the
``GQMAP_DATA`` environment variable, else a ``middlebury/`` directory beside
the package. Four sequences also ship structure-texture preprocessed inputs
as ``preprocessed/<Name>.mat`` (``optical_flowSuper.m:12-14``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .flo import read_flo
from .images import load_image, rgb2gray

__all__ = ["Sequence", "crop_to_multiple", "data_root", "list_sequences",
           "load_sequence", "SEQUENCES"]

# Canonical sequence directory names as shipped (note lower-case rubberwhale).
SEQUENCES = [
    "rubberwhale",
    "Dimetrodon",
    "Hydrangea",
    "Venus",
    "Grove2",
    "Grove3",
    "Urban2",
    "Urban3",
    "Teddy",
    "Cones",
]

PREPROCESSED = {"rubberwhale": "RubberWhale", "Dimetrodon": "Dimetrodon",
                "Hydrangea": "Hydrangea", "Venus": "Venus"}


class Sequence(NamedTuple):
    name: str
    img1: np.ndarray          # (M, N) float64 grayscale, MATLAB parity
    img2: np.ndarray          # (M, N) float64
    gt_flow: np.ndarray | None  # (M, N, 2) float32 raw GT (may contain 1e10 unknowns)


def data_root() -> Path:
    root = os.environ.get("GQMAP_DATA")
    if root:
        return Path(root)
    cand = Path(__file__).resolve().parents[2] / "middlebury"
    if cand.is_dir():
        return cand
    raise FileNotFoundError("Middlebury data not found; set GQMAP_DATA to the dataset root")


def list_sequences(with_gt: bool = True) -> list[str]:
    root = data_root()
    out = []
    for name in SEQUENCES:
        d = root / name
        if not d.is_dir():
            continue
        if with_gt and not (d / "flow10.flo").is_file():
            continue
        out.append(name)
    return out


def crop_to_multiple(seq: Sequence, k) -> Sequence:
    """Crop frames (and GT) so both dims are multiples of ``k`` (an int, or
    a per-dim ``(km, kn)`` pair).

    The super lattice (``gqmap_gpuSuper_mix_entropy.m:11``) needs the image
    to tile into ``k x k`` patches; rescaled runs generally don't, so a
    ragged bottom/right edge is dropped."""
    km, kn = (k, k) if isinstance(k, int) else k
    if km <= 1 and kn <= 1:
        return seq
    M, N = seq.img1.shape
    Mc, Nc = (M // km) * km, (N // kn) * kn
    if (Mc, Nc) == (M, N):
        return seq
    gt = seq.gt_flow[:Mc, :Nc] if seq.gt_flow is not None else None
    return Sequence(seq.name, seq.img1[:Mc, :Nc], seq.img2[:Mc, :Nc], gt)


def load_sequence(name: str, scale: float = 1.0, preprocessed: bool = False,
                  st_preprocess: bool = False, device=None) -> Sequence:
    """Load frames (grayscale float64) + raw GT flow for a sequence.

    ``preprocessed`` loads the shipped ``.mat`` inputs (4 sequences only);
    ``st_preprocess`` computes the structure-texture decomposition for any
    sequence (:mod:`gqmap_tpu_torch.io.preprocess`), on ``device`` (the GPU
    by default; ``device="cpu"`` for the CPU). The PNG frames need
    ``imageio``."""
    root = data_root()
    d = root / name
    if not d.is_dir():
        # tolerate case differences (RubberWhale vs rubberwhale)
        matches = [s for s in SEQUENCES if s.lower() == name.lower()]
        if matches and (root / matches[0]).is_dir():
            d = root / matches[0]
            name = matches[0]
        else:
            raise FileNotFoundError(f"sequence {name!r} not under {root}")

    if preprocessed:
        import scipy.io

        mat = scipy.io.loadmat(root / "preprocessed" / f"{PREPROCESSED[name]}.mat")
        img1, img2 = mat["img1"].astype(np.float64), mat["img2"].astype(np.float64)
    else:
        img1 = rgb2gray(load_image(d / "frame10.png"))
        img2 = rgb2gray(load_image(d / "frame11.png"))
        if scale != 1.0:
            from .images import imresize

            img1 = imresize(img1, scale)
            img2 = imresize(img2, scale)
        if st_preprocess:
            from .preprocess import structure_texture

            img1 = structure_texture(img1, device=device)
            img2 = structure_texture(img2, device=device)

    flo_path = d / "flow10.flo"
    gt = read_flo(flo_path) if flo_path.is_file() else None
    if gt is not None and scale != 1.0 and not preprocessed:
        # resized GT: sanitize the 1e10 unknown sentinels first (they would
        # bleed into neighbors under interpolation), then scale values
        from ..ops.flowviz import flow_to_color
        from .images import imresize

        clean = flow_to_color(np.asarray(gt, np.float64)).flo
        gt = (imresize(clean, img1.shape) * scale).astype(np.float32)
    return Sequence(name, img1, img2, gt)
