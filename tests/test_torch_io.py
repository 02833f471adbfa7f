"""The port's I/O modules and the coarse-to-fine warp's ops against the JAX package.

``gqmap_tpu_torch/io/{flo,images,dataset,preprocess}.py`` and
``ops/interp.{interp2_linear,fill_missing_nearest}`` on the same numpy
inputs as ``gqmap_tpu``'s, at small sizes. Tolerances: the numpy copies
(``.flo`` files, ``rgb2gray``, ``imresize``, the dataset's frames and GT)
are exact, bytes or ``array_equal``; the Chambolle loop (torch f64 against
JAX's jitted x64 ``fori_loop``) within 1e-10 of the image's range; the
bilinear warp and the nearest fill within 1e-12, with identical NaN
positions. Datasets are written under ``tmp_path`` and found through
``GQMAP_DATA``.
"""

import os
import struct

import numpy as np
import pytest
import torch

from _torch_common import write_sequence
from gqmap_tpu.io import dataset as jds
from gqmap_tpu.io import flo as jflo
from gqmap_tpu.io import images as jim
from gqmap_tpu.io import preprocess as jpre
from gqmap_tpu.ops import interp as jinterp
from gqmap_tpu_torch.io import dataset as pds
from gqmap_tpu_torch.io import flo as pflo
from gqmap_tpu_torch.io import images as pim
from gqmap_tpu_torch.io import preprocess as ppre
from gqmap_tpu_torch.ops import interp as pinterp


# ---- .flo files

def test_flo_files_are_byte_identical(tmp_path):
    r = np.random.default_rng(0)
    flow = r.normal(size=(13, 17, 2)) * 5
    flow[3, 4] = 1e10
    paths = {}
    for name, mod in (("jax", jflo), ("port", pflo)):
        paths[name] = str(tmp_path / f"{name}.flo")
        mod.write_flo(paths[name], flow)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    got, want = pflo.read_flo(paths["jax"]), jflo.read_flo(paths["port"])
    assert got.dtype == want.dtype == np.float32 and got.shape == (13, 17, 2)
    assert np.array_equal(got, want) and np.array_equal(got, flow.astype(np.float32))


def _bad_flo(path, case):
    w, h = 4, 3
    body = np.zeros(w * h * 2, "<f4").tobytes()
    raw = {
        "header": struct.pack("<f", 202021.25) + struct.pack("<i", w),
        "tag": struct.pack("<fii", 202021.0, w, h) + body,
        "width": struct.pack("<fii", 202021.25, 0, h) + body,
        "height": struct.pack("<fii", 202021.25, w, 100000) + body,
        "data": struct.pack("<fii", 202021.25, w, h) + body[:-4],
    }[case]
    with open(path, "wb") as f:
        f.write(raw)


@pytest.mark.parametrize("case", ["extension", "header", "tag", "width", "height", "data",
                                  "write_extension", "write_bands"])
def test_bad_flo_is_rejected_the_same_way(tmp_path, case):
    path = str(tmp_path / ("bad.flo" if case != "extension" else "bad.flw"))
    msgs = []
    for mod in (jflo, pflo):
        if case.startswith("write"):
            flow = np.zeros((3, 4, 3 if case == "write_bands" else 2))
            target = path if case == "write_bands" else str(tmp_path / "out.png")
            with pytest.raises(ValueError) as e:
                mod.write_flo(target, flow)
        else:
            if case != "extension":
                _bad_flo(path, case)
            with pytest.raises(ValueError) as e:
                mod.read_flo(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- images

def _image(kind):
    r = np.random.default_rng(len(kind))
    return {
        "uint8_rgb": r.integers(0, 256, (19, 23, 3), dtype=np.uint8),
        "uint8_rgba": r.integers(0, 256, (11, 7, 4), dtype=np.uint8),
        "float_rgb": r.uniform(0, 1, (9, 14, 3)),
        "gray": r.uniform(0, 255, (12, 10)),
    }[kind]


@pytest.mark.parametrize("kind", ["uint8_rgb", "uint8_rgba", "float_rgb", "gray"])
def test_rgb2gray_equals_jax(kind):
    img = _image(kind)
    got, want = pim.rgb2gray(img), jim.rgb2gray(img)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind, size, antialias", [
    ("uint8_rgb", 0.5, True), ("uint8_rgb", 0.37, True), ("gray", 0.125, True),
    ("gray", (29, 17), True), ("float_rgb", 2.0, True), ("gray", 0.5, False),
    ("uint8_rgba", 1.7, True),
])
def test_imresize_equals_jax(kind, size, antialias):
    img = _image(kind)
    got = pim.imresize(img, size, antialias=antialias)
    want = jim.imresize(img, size, antialias=antialias)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_load_image_reads_png(tmp_path):
    import imageio.v2 as imageio

    img = _image("uint8_rgb")
    imageio.imwrite(tmp_path / "a.png", img)
    assert np.array_equal(pim.load_image(tmp_path / "a.png"), jim.load_image(tmp_path / "a.png"))
    assert np.array_equal(pim.load_image(tmp_path / "a.png"), img)


# ---- the dataset registry

@pytest.fixture
def data(tmp_path, monkeypatch):
    monkeypatch.setenv("GQMAP_DATA", str(tmp_path))
    frames = {name: write_sequence(tmp_path, name, 30, 42, seed=i)
              for i, name in enumerate(("Venus", "Dimetrodon"))}
    os.makedirs(tmp_path / "Teddy")  # a sequence without GT
    return frames


def _assert_sequences_equal(got, want):
    assert got.name == want.name
    for f in ("img1", "img2"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    if want.gt_flow is None:
        assert got.gt_flow is None
    else:
        assert got.gt_flow.dtype == want.gt_flow.dtype
        assert np.array_equal(got.gt_flow, want.gt_flow)


@pytest.mark.parametrize("kw", [dict(), dict(preprocessed=True), dict(scale=0.5),
                                dict(scale=0.7, preprocessed=True)])
def test_load_sequence_equals_jax(data, kw):
    got, want = pds.load_sequence("Venus", **kw), jds.load_sequence("Venus", **kw)
    _assert_sequences_equal(got, want)
    if not kw:
        img1, img2, gt = data["Venus"]
        assert np.array_equal(got.img1, img1) and np.array_equal(got.gt_flow, gt)
        assert (got.gt_flow > 1e9).sum() == 10  # 5 unknown pixels, both bands
    if kw.get("scale") == 0.5:
        # the resized GT: unknown sentinels cleared before the resize
        assert got.gt_flow.shape == (15, 21, 2) and np.abs(got.gt_flow).max() < 10


def test_load_sequence_st_preprocess_agrees(data):
    got = pds.load_sequence("Dimetrodon", st_preprocess=True, device="cpu")
    want = jds.load_sequence("Dimetrodon", st_preprocess=True)
    for f in ("img1", "img2"):
        a, b = getattr(got, f), getattr(want, f)
        assert np.abs(a - b).max() <= 1e-10 * (b.max() - b.min())
    assert np.array_equal(got.gt_flow, want.gt_flow)


def test_registry_equals_jax(data, tmp_path):
    assert pds.data_root() == jds.data_root() == tmp_path
    assert pds.SEQUENCES == jds.SEQUENCES
    for with_gt in (True, False):
        assert pds.list_sequences(with_gt) == jds.list_sequences(with_gt)
    assert pds.list_sequences() == ["Dimetrodon", "Venus"]
    # names are matched without regard to case
    _assert_sequences_equal(pds.load_sequence("venus"), jds.load_sequence("venus"))
    for mod in (pds, jds):
        with pytest.raises(FileNotFoundError, match="not under"):
            mod.load_sequence("Grove2")


@pytest.mark.parametrize("k", [4, (3, 8), 1])
def test_crop_to_multiple_equals_jax(data, k):
    seq = pds.load_sequence("Venus")
    got, want = pds.crop_to_multiple(seq, k), jds.crop_to_multiple(seq, k)
    _assert_sequences_equal(got, want)
    km, kn = (k, k) if isinstance(k, int) else k
    assert got.img1.shape[0] % km == 0 and got.img1.shape[1] % kn == 0


# ---- structure-texture preprocessing

@pytest.mark.parametrize("fn, kw", [("rof_structure", dict()),
                                    ("rof_structure", dict(theta=0.3, iters=37)),
                                    ("structure_texture", dict()),
                                    ("structure_texture", dict(blend=0.8, tau=0.2))])
def test_preprocess_agrees_with_jax_f64(fn, kw):
    r = np.random.default_rng(7)
    img = r.uniform(0, 255, (33, 41))
    got = getattr(ppre, fn)(img, device="cpu", **kw)
    want = getattr(jpre, fn)(img, **kw)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * (img.max() - img.min())


def test_preprocess_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppre.structure_texture(np.ones((8, 8)))


# ---- the coarse-to-fine warp: interp2_linear and fill_missing_nearest

def _assert_nan_close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) <= tol


def test_interp2_linear_agrees_with_jax():
    r = np.random.default_rng(3)
    M, N = 7, 9
    V = r.normal(size=(M, N))
    X = r.uniform(-0.5, N + 1.5, (25, 30))
    Y = r.uniform(-0.5, M + 1.5, (25, 30))
    # the grid's edges: exactly 1 and N (the last cell, weight 1 on its far
    # side), just outside (NaN), and the corners
    X[0, :8] = [1.0, N, N, N - 1e-12, N + 1e-9, 1 - 1e-9, 1.0, N]
    Y[0, :8] = [1.0, M, 3.5, M, 2.0, 2.0, M, 1.0]
    got = pinterp.interp2_linear(torch.as_tensor(V), X, Y).numpy()
    want = np.asarray(jinterp.interp2_linear(V, X, Y))
    _assert_nan_close(got, want)
    assert got[0, 0] == V[0, 0] and got[0, 1] == V[-1, -1] and got[0, 7] == V[0, -1]
    assert np.isnan(got[0, 4]) and np.isnan(got[0, 5])
    # a custom fill, and broadcast query grids
    x = 1.0 + np.arange(N + 2)[None, :] - 1.0
    y = 1.0 + np.arange(M)[:, None]
    _assert_nan_close(pinterp.interp2_linear(torch.as_tensor(V), x, y, fill=-7.0).numpy(),
                      np.asarray(jinterp.interp2_linear(V, x, y, fill=-7.0)))


@pytest.mark.parametrize("case", ["random", "ends", "ties", "all_nan_row", "all_nan",
                                  "no_nan", "single_column"])
def test_fill_missing_nearest_agrees_with_jax(case):
    r = np.random.default_rng(11)
    A = r.normal(size=(6, 9))
    if case == "random":
        A[r.uniform(size=A.shape) < 0.45] = np.nan
    elif case == "ends":
        # first and last entries of rows and columns missing
        A[:, 0] = A[:, -1] = np.nan
        A[0, :] = A[-1, :] = np.nan
        A[2, :3] = np.nan
    elif case == "ties":
        # one missing entry between two valid ones at equal distance: the
        # following one wins (MATLAB 'nearest')
        A[:, 1::2] = np.nan
        A[1, :] = np.nan
    elif case == "all_nan_row":
        A[3, :] = np.nan
        A[:, 4] = np.nan
    elif case == "all_nan":
        A[:] = np.nan
    elif case == "single_column":
        A = A[:, :1].copy()
        A[[0, 2, 5]] = np.nan
    got = pinterp.fill_missing_nearest(torch.as_tensor(A)).numpy()
    want = np.asarray(jinterp.fill_missing_nearest(A))
    _assert_nan_close(got, want, 0.0)
    if case == "ties":
        assert got[0, 1] == A[0, 2] and got[0, 7] == A[0, 8]
        assert np.array_equal(got[1], got[2])  # the missing row takes the following one
    if case == "all_nan":
        assert np.isnan(got).all()
