"""Image loading and MATLAB-parity conversions (host-side, numpy).

* :func:`rgb2gray` — MATLAB's exact ITU-601 coefficients with uint8
  rounding, so ``double(rgb2gray(img))`` matches bit-for-bit
  (used by every driver, e.g. ``optical_flow.m:10-11``).
* :func:`imresize` — MATLAB ``imresize`` (bicubic, antialiased) used by the
  coarse-to-fine pyramid (``legacy/optical_flow_ctf.m:26-29``).

A copy of ``gqmap_tpu/io/images.py`` (numpy; :func:`load_image` imports
``imageio`` when it is called): the port cannot import the JAX package,
whose ``__init__`` imports JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "rgb2gray", "imresize"]

# MATLAB rgb2gray: T = inv([1 .956 .621; 1 -.272 -.647; 1 -1.106 1.703])(1,:)
_COEF = np.array([0.298936021293775, 0.587043074451121, 0.114020904255103])


def load_image(path) -> np.ndarray:
    """Load an image file as a uint8 numpy array (H, W[, C])."""
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """MATLAB ``double(rgb2gray(uint8 img))``: weighted sum + round.

    Returns float64 integers in [0, 255] for uint8 input; float inputs are
    converted without rounding (MATLAB semantics for double images).
    """
    img = np.asarray(img)
    if img.ndim == 2:
        return img.astype(np.float64)
    gray = img[..., :3].astype(np.float64) @ _COEF
    if img.dtype == np.uint8:
        gray = np.clip(np.round(gray), 0, 255)
    return gray


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic (a = -0.5), MATLAB imresize's 'bicubic' kernel."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1,
        1.5 * ax3 - 2.5 * ax2 + 1.0,
        np.where(ax <= 2, -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0, 0.0),
    )


def _resize_weights(in_len: int, out_len: int, scale: float, antialias: bool = True):
    """MATLAB imresize "contributions": weights + indices for one dimension."""
    aa = scale if (antialias and scale < 1) else 1.0
    kernel_width = 4.0 / aa
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    P = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(P)[None, :]
    weights = aa * _cubic_kernel(aa * (u[:, None] - indices))
    weights /= weights.sum(axis=1, keepdims=True)
    # replicate boundary
    indices = np.clip(indices, 1, in_len).astype(np.int64) - 1
    # drop all-zero columns
    keep = ~np.all(weights == 0, axis=0)
    return weights[:, keep], indices[:, keep]


def imresize(img: np.ndarray, scale_or_size, antialias: bool = True) -> np.ndarray:
    """MATLAB ``imresize(img, scale)`` / ``imresize(img, [h w])``, bicubic.

    Supports 2-D and 3-D (channel-last) arrays; uint8 inputs are resized in
    double precision and rounded back like MATLAB.
    """
    img = np.asarray(img)
    in_h, in_w = img.shape[:2]
    if np.isscalar(scale_or_size):
        out_h = int(np.ceil(in_h * scale_or_size))
        out_w = int(np.ceil(in_w * scale_or_size))
    else:
        out_h, out_w = scale_or_size
    scale_h = out_h / in_h
    scale_w = out_w / in_w

    was_uint8 = img.dtype == np.uint8
    work = img.astype(np.float64)
    squeeze = work.ndim == 2
    if squeeze:
        work = work[..., None]

    wh, ih = _resize_weights(in_h, out_h, scale_h, antialias)
    ww, iw = _resize_weights(in_w, out_w, scale_w, antialias)
    work = _apply_dim(work, wh, ih, axis=0)
    work = _apply_dim(work, ww, iw, axis=1)

    if squeeze:
        work = work[..., 0]
    if was_uint8:
        work = np.clip(np.round(work), 0, 255).astype(np.uint8)
    return work


def _apply_dim(a: np.ndarray, weights: np.ndarray, indices: np.ndarray, axis: int):
    """Apply 1-D resampling weights along ``axis`` of a 3-D array."""
    moved = np.moveaxis(a, axis, 0)          # (in_len, ...)
    gathered = moved[indices]                # (out_len, P, ...)
    out = np.einsum("op,op...->o...", weights, gathered)
    return np.moveaxis(out, 0, axis)
