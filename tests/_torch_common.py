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
        interior=np.asarray(jp.interior), rng=tuple(jp.rng), cheb=np_fields(jp.cheb)))


def port_state(js):
    return state_from_numpy(np_fields(js))


def t(x):
    return torch.as_tensor(np.array(x))


def assert_close(got, want, rtol, atol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def assert_fields_close(got, want, rtol, atol, fields=None):
    for f in fields or want._fields:
        assert_close(getattr(got, f), getattr(want, f), rtol, atol, f)
