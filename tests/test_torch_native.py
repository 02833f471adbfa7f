"""The port's ctypes binding (``gqmap_tpu_torch/native.py``) to the C++
ports of the reference's ``.mexw64`` binaries, against the port's own ops,
as ``tests/test_native.py`` holds the JAX package's ops to them. Skips where
the library cannot be built."""

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from gqmap_tpu_torch import native


@pytest.fixture(scope="module", autouse=True)
def library():
    try:
        native._load()
    except native.NativeUnavailable as e:
        pytest.skip(f"no native library: {e}")


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).normal(size=(19, 23)) * 40 + 120


def test_get_vv_matches_pad_cubic(image):
    from gqmap_tpu_torch.ops.interp import pad_cubic

    want = pad_cubic(torch.as_tensor(image)).numpy()
    np.testing.assert_allclose(native.get_vv(image), want, rtol=1e-13, atol=1e-10)


def test_sample_bicubic_matches(image):
    from gqmap_tpu_torch.ops.interp import pad_cubic, sample_bicubic

    VV = native.get_vv(image)
    r = np.random.default_rng(9)
    Xq, Yq = r.uniform(-1, 25, 500), r.uniform(-1, 21, 500)
    got = native.sample_bicubic(VV, Xq, Yq)
    want = sample_bicubic(pad_cubic(torch.as_tensor(image)), torch.as_tensor(Xq),
                          torch.as_tensor(Yq)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_mixture_map_matches():
    from gqmap_tpu_torch.ops.mixture import extract_map, mixture_neg_pdf

    r = np.random.default_rng(3)
    M, N, L = 6, 7, 3
    alpha = r.dirichlet(np.ones(L))
    muu, muv = r.normal(size=(M, N, L)) * 2, r.normal(size=(M, N, L)) * 2
    sgu, sgv = r.uniform(0.3, 2.0, (M, N, L)), r.uniform(0.3, 2.0, (M, N, L))
    got = native.mixture_map(alpha, muu, sgu, muv, sgv)

    def lmn(a):  # the port's (L, M, N) layout
        return torch.as_tensor(np.moveaxis(a, -1, 0))

    a = torch.as_tensor(alpha)
    want = extract_map(a, *map(lmn, (muu, sgu, muv, sgv))).numpy()
    # compare by the density reached per channel (modes can tie)
    for chan, (mu, sg) in enumerate([(muu, sgu), (muv, sgv)]):
        mu, sg = torch.as_tensor(mu), torch.as_tensor(sg)
        pg = mixture_neg_pdf(torch.as_tensor(got[..., chan]), a, mu, sg)
        pw = mixture_neg_pdf(torch.as_tensor(want[..., chan]), a, mu, sg)
        np.testing.assert_allclose(pg.numpy(), pw.numpy(), rtol=1e-5, atol=1e-8)


def test_flow_to_color_matches():
    from gqmap_tpu_torch.ops.flowviz import flow_to_color

    r = np.random.default_rng(1)
    flow = r.normal(size=(12, 14, 2)) * 3
    flow[2, 3] = [1e10, 5.0]
    img, flo, minu, maxu, minv, maxv, unk = native.flow_to_color(flow)
    ref = flow_to_color(flow)
    np.testing.assert_array_equal(img, ref.img)
    np.testing.assert_allclose(flo, ref.flo)
    assert (minu, maxu, minv, maxv) == (ref.minu, ref.maxu, ref.minv, ref.maxv)
    np.testing.assert_array_equal(unk, ref.unknown)


def test_flo_roundtrip_cross(tmp_path):
    from gqmap_tpu_torch.io.flo import read_flo, write_flo

    flow = np.random.default_rng(2).normal(size=(9, 11, 2)).astype(np.float32)
    native.write_flo(tmp_path / "a.flo", flow)
    np.testing.assert_array_equal(read_flo(tmp_path / "a.flo"), flow)
    write_flo(tmp_path / "b.flo", flow)
    np.testing.assert_array_equal(native.read_flo(tmp_path / "b.flo"), flow)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()


def test_unbuildable_library_raises(tmp_path, monkeypatch):
    # no library and no Makefile to build one: NativeUnavailable, not OSError
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ROOT", tmp_path)
    monkeypatch.setattr(native, "_LIB", tmp_path / "libgqmap_native.so")
    assert not native.available()
    with pytest.raises(native.NativeUnavailable):
        native.get_vv(np.zeros((3, 3)))
