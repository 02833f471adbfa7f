"""Shared helpers of the PyTorch port's CPU parity tests (tests/test_torch_*.py).

Inputs come from numpy seeds and go through the JAX function and its
counterpart in ``gqmap_tpu_torch``, both in float64 (conftest enables x64).
The tier-1 run uses several pytest-xdist workers, so each worker keeps torch
to one thread.
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from gqmap_tpu_torch.convert import problem_from_numpy, state_from_numpy

torch.set_num_threads(1)


def shifted_pair(M=24, N=28, seed=0):
    """Smooth random frame pair with a known 1-px horizontal shift (u=1, v=0)."""
    r = np.random.default_rng(seed)
    I1 = gaussian_filter(r.uniform(0, 255, (M, N)), 1.5)
    I2 = np.empty_like(I1)
    I2[:, 1:] = I1[:, :-1]
    I2[:, 0] = I1[:, 0]
    gt = np.zeros((M, N, 2))
    gt[..., 0] = 1.0
    return I1, I2, gt


def np_fields(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def port_problem(jp):
    """The port's Problem holding exactly the JAX Problem's arrays."""
    return problem_from_numpy(dict(
        I1=np.asarray(jp.I1), I2_tab=np.asarray(jp.I2_tab),
        interior=np.asarray(jp.interior), rng=tuple(jp.rng), cheb=np_fields(jp.cheb)),
        device="cpu")


def port_state(js):
    return state_from_numpy(np_fields(js), device="cpu")


def t(x):
    return torch.as_tensor(np.array(x))


def assert_close(got, want, rtol, atol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def assert_fields_close(got, want, rtol, atol, fields=None):
    for f in fields or want._fields:
        assert_close(getattr(got, f), getattr(want, f), rtol, atol, f)


def smooth_flow_pair(M=64, N=64, seed=4, v_amp=0.0):
    """The smooth-flow pair of ``tests/test_pipeline.py:46-67``: u = 1.5 +
    1.5 cos(2 pi y / M), v = ``v_amp`` sin(2 pi x / N) (0 there; a constant
    GT gives a degenerate clamp box), frame 2 backward-generated by the
    port's bilinear warp (bit for bit the JAX package's,
    ``tests/test_torch_io.py``)."""
    from gqmap_tpu_torch.ops.interp import fill_missing_nearest, interp2_linear

    r = np.random.default_rng(seed)
    I1 = gaussian_filter(r.uniform(0, 255, (M, N)), 2.0)
    yy, xx = np.mgrid[0:M, 0:N].astype(float)
    u = 1.5 + 1.5 * np.cos(2 * np.pi * yy / M)
    v = v_amp * np.sin(2 * np.pi * xx / N)
    I2 = fill_missing_nearest(interp2_linear(torch.as_tensor(I1), (xx + 1) - u,
                                             (yy + 1) - v)).numpy()
    return I1, I2, np.stack([u, v], -1)


def write_sequence(root, name, M=32, N=40, seed=0, unknown=5):
    """A Middlebury-layout sequence under ``root``: RGB ``frame10.png`` and
    ``frame11.png`` (uint8), ``flow10.flo`` with ``unknown`` pixels at the
    1e10 sentinel, and ``preprocessed/<name>.mat`` (``img1``, ``img2``).
    The flow is :func:`smooth_flow_pair`'s with v up to 0.5 px, so both
    channels' clamp boxes have a width (``reset_para`` re-widens sigma to
    half of it). Returns the frames as grayscale float64 and the GT as
    written."""
    import os

    import imageio.v2 as imageio
    import scipy.io

    from gqmap_tpu_torch.io.flo import write_flo
    from gqmap_tpu_torch.io.images import rgb2gray

    I1, I2, gt = smooth_flow_pair(M, N, seed, v_amp=0.5)
    r = np.random.default_rng(seed + 100)
    d = os.path.join(root, name)
    os.makedirs(os.path.join(root, "preprocessed"), exist_ok=True)
    os.makedirs(d, exist_ok=True)
    frames = []
    for fname, img in (("frame10.png", I1), ("frame11.png", I2)):
        rgb = np.clip(np.round(img[..., None] * [1.0, 0.9, 0.8]
                               + r.uniform(-3, 3, img.shape + (3,))), 0, 255).astype(np.uint8)
        imageio.imwrite(os.path.join(d, fname), rgb)
        frames.append(rgb2gray(rgb))
    gt = gt.astype(np.float32)
    bad = r.choice(M * N, unknown, replace=False)
    gt.reshape(-1, 2)[bad] = 1e10
    write_flo(os.path.join(d, "flow10.flo"), gt)
    scipy.io.savemat(os.path.join(root, "preprocessed", f"{name}.mat"),
                     dict(img1=I1, img2=I2))
    return frames[0], frames[1], gt
