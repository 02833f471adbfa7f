"""Build and load the hand-written Hopper kernels (``gqmap_tpu_torch/csrc/*.cu``).

Each CUDA source compiles with its own ``nvcc``, all started together (the
build takes as long as the slowest source, not the sum), and the objects
link into ONE shared library with a plain C interface, loaded with
:mod:`ctypes` at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o <obj> csrc/<source>.cu        (one per source)
    nvcc -shared -o gqmap_tpu_torch/_build/libgqmap_kernels_<hash>.so <objs>

The file name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is a cache hit. The library is written under a temporary
name and renamed into place, so concurrent first uses do not
collide. A missing ``nvcc`` or a failed build raises; there is no fallback.
The library is built for ``sm_90a`` only, so :func:`library_for` refuses a
device of any other compute capability before a launch (checked once a
device).
The compiler's report (each source's ``nvcc`` seconds, and ``-Xptxas -v``:
registers and spills per kernel) is kept beside the library as
``<name>.log``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

__all__ = ["build_library", "library_path", "load_library", "library_for",
           "require_capability", "check", "check_operands", "rule_args", "rule_fits",
           "NVCC_FLAGS", "CAPABILITY", "RULE_SHARED_BYTES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CAPABILITY = (9, 0)  # the one target of NVCC_FLAGS: sm_90a, Hopper
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # sp, coeffs, out, counters, L, Lt, S, A, B, variant, device, stream
    "gqmap_cos_mode_sums_f32": [_P] * 4 + [_I] * 7 + [_P],
    "gqmap_cos_mode_sums_f64": [_P] * 4 + [_I] * 7 + [_P],
    # mu, sg, rou, alpha, T, rule_host, rule_dev, out, C, L, M, N, K1, lam, eps, es,
    # device, stream
    "gqmap_edge_reduced_f32": [_P] * 8 + [_I] * 5 + [_D] * 3 + [_I, _P],
    "gqmap_edge_reduced_f64": [_P] * 8 + [_I] * 5 + [_D] * 3 + [_I, _P],
    # mu, sg, u2e, o2e, rou, rule_host, rule_dev, out, DC, C, L, S, K, lam, eps, device,
    # stream
    "gqmap_edge_gq_f32": [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _P],
    "gqmap_edge_gq_f64": [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # I1, VV, muu, muv, su, sv, pn, rule_host, out, l1_counts, No, M2, N2, L, M, N, P, r0, c0,
    # K, variant, window_bytes, lam, eps, device, stream
    "gqmap_node_gq_f32": [_P] * 10 + [_I] * 12 + [_D] * 2 + [_I, _P],
    "gqmap_node_gq_f64": [_P] * 10 + [_I] * 12 + [_D] * 2 + [_I, _P],
    # I1, VV, muu, muv, su, sv, pn, rule_host, out, l1_counts, Mo, No, M2, N2, L, M, N, r0, c0,
    # K, rg, window_bytes, generic, variant, lam, eps, device, stream (kernels/window_gq, K12)
    "gqmap_window_gq_f32": [_P] * 10 + [_I] * 14 + [_D] * 2 + [_I, _P],
    "gqmap_window_gq_f64": [_P] * 10 + [_I] * 14 + [_D] * 2 + [_I, _P],
    # double, variant, K, rg, generic, window_bytes, device, regs, local_bytes, ctas (K12's
    # instance report, kernels/window_gq.occupancy)
    "gqmap_window_gq_occupancy": [_I] * 7 + [_P] * 3,
    # coeffs, muu, muv, su, sv, pn, rule_host, out, L, S, P, Q, K, variant, cu, ru, cv, rv,
    # device, stream
    "gqmap_cheb_gq_f32": [_P] * 8 + [_I] * 6 + [_D] * 4 + [_I, _P],
    "gqmap_cheb_gq_f64": [_P] * 8 + [_I] * 6 + [_D] * 4 + [_I, _P],
    # I1, tab, muu, muv, su, sv, pn, rule_host, out, Mo, No, MM, NN, L, M, N, r0, c0, K, rg,
    # rfc, lam, eps, device, stream
    "gqmap_nearest_gq_f32": [_P] * 9 + [_I] * 12 + [_D] * 2 + [_I, _P],
    "gqmap_nearest_gq_f64": [_P] * 9 + [_I] * 12 + [_D] * 2 + [_I, _P],
    # I1, tab, tab_u, tab_v, muu, muv, su, sv, pn, rule_host, out, Mo, No, MM, NN, L, M, N, r0,
    # c0, K, rfc, lam, eps, device, stream
    "gqmap_nearest_chain_f32": [_P] * 11 + [_I] * 11 + [_D] * 2 + [_I, _P],
    "gqmap_nearest_chain_f64": [_P] * 11 + [_I] * 11 + [_D] * 2 + [_I, _P],
    # I1, pad, wts, muu, muv, su, sv, pn, rule_host, out, Mo, No, M2, N2, L, M, N, r0, c0, K,
    # rg, rfc, lam, eps, device, stream
    "gqmap_nearest_gq_v2_f32": [_P] * 10 + [_I] * 12 + [_D] * 2 + [_I, _P],
    "gqmap_nearest_gq_v2_f64": [_P] * 10 + [_I] * 12 + [_D] * 2 + [_I, _P],
    # I1, pad, pad_u, pad_v, wts, muu, muv, su, sv, pn, rule_host, out, Mo, No, M2, N2, L, M, N,
    # r0, c0, K, rfc, lam, eps, device, stream
    "gqmap_nearest_chain_v2_f32": [_P] * 12 + [_I] * 11 + [_D] * 2 + [_I, _P],
    "gqmap_nearest_chain_v2_f64": [_P] * 12 + [_I] * 11 + [_D] * 2 + [_I, _P],
    # muu, muv, su, sv, pn, prior, rule_host, rule_dev, out, L, M, N, K, the prior's strides
    # (3, in elements), scale, device, stream (kernels/quad_gq.quad_node_gq_cuda, K10)
    "gqmap_quad_node_gq_f32": [_P] * 9 + [_I] * 7 + [_D, _I, _P],
    "gqmap_quad_node_gq_f64": [_P] * 9 + [_I] * 7 + [_D, _I, _P],
    # mu, sg, u2e, o2e, rou, rule_host, rule_dev, out, DC, C, L, S, K, dta, scale, device,
    # stream (kernels/quad_gq.truncquad_edge_gq_cuda, K11)
    "gqmap_truncquad_edge_gq_f32": [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _P],
    "gqmap_truncquad_edge_gq_f64": [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # muu, muv, su, sv, pn, prior, table, out, L, M, N, the prior's strides (3), scale,
    # device, stream (quad_node_gq_cuda, K10 v2)
    "gqmap_quad_node_gq_v2_f32": [_P] * 8 + [_I] * 6 + [_D, _I, _P],
    "gqmap_quad_node_gq_v2_f64": [_P] * 8 + [_I] * 6 + [_D, _I, _P],
    # mu, sg, u2e, o2e, rou, table, nodes, out, counts, DC, C, L, S, K, generic, coop_lanes,
    # dta, scale, device, stream (truncquad_edge_gq_cuda, K11 v2)
    "gqmap_truncquad_edge_gq_v2_f32": [_P] * 9 + [_I] * 7 + [_D] * 2 + [_I, _P],
    "gqmap_truncquad_edge_gq_v2_f64": [_P] * 9 + [_I] * 7 + [_D] * 2 + [_I, _P],
    # I1, VV, muu, muv, su, sv, pn, rule, out, Mo, No, L, M, N, r0, c0, K, lam, eps, device,
    # stream (kernels/autodiff_gq.node_chain_gq_cuda, K13)
    "gqmap_node_chain_f32": [_P] * 9 + [_I] * 8 + [_D] * 2 + [_I, _P],
    "gqmap_node_chain_f64": [_P] * 9 + [_I] * 8 + [_D] * 2 + [_I, _P],
    # mu, sg, u2e, o2e, rou, rule, out, DC, C, L, S, K, lam, eps, device, stream
    # (kernels/autodiff_gq.edge_chain_gq_cuda, K14)
    "gqmap_edge_chain_f32": [_P] * 7 + [_I] * 5 + [_D] * 2 + [_I, _P],
    "gqmap_edge_chain_f64": [_P] * 7 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # I1, VV, muu, muv, su, sv, pn, rule_host, out, l1_counts, Mo, No, L, M, N, r0, c0, K,
    # patch, window_bytes, generic, lam, eps, device, stream (node_chain_gq_cuda, K13 v2)
    "gqmap_node_chain_v2_f32": [_P] * 10 + [_I] * 11 + [_D] * 2 + [_I, _P],
    "gqmap_node_chain_v2_f64": [_P] * 10 + [_I] * 11 + [_D] * 2 + [_I, _P],
    # I1, VV, muu, muv, su, sv, pn, rule_host, out, l1_counts, Mo, No, L, M, N, r0, c0, K,
    # rg, window_bytes, generic, lam, eps, device, stream (node_window_chain_gq_cuda, K16)
    "gqmap_window_chain_f32": [_P] * 10 + [_I] * 11 + [_D] * 2 + [_I, _P],
    "gqmap_window_chain_f64": [_P] * 10 + [_I] * 11 + [_D] * 2 + [_I, _P],
    # double_, K, rg, generic, window_bytes, device, regs, local_bytes, ctas
    # (autodiff_gq.occupancy: K16, and K13 v2 at patch 4 as rg 0)
    "gqmap_chain_occupancy": [_I] * 6 + [_P] * 3,
    # mu, sg, u2e, o2e, rou, rule_host, rule_dev, out, DC, C, L, S, K, lam, eps, device,
    # stream (edge_chain_gq_cuda, K14 v2)
    "gqmap_edge_chain_v2_f32": [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _P],
    "gqmap_edge_chain_v2_f64": [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # mu, sg, rou, rule, out, C, L, M, N, K1, lam, eps, device, stream
    # (kernels/autodiff_gq.edge_diff_adjoint_cuda, K15)
    "gqmap_edge_diff_f32": [_P] * 5 + [_I] * 5 + [_D] * 2 + [_I, _P],
    "gqmap_edge_diff_f64": [_P] * 5 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # mu, sg, rou, rule_host, rule_dev, out, C, L, M, N, K1, lam, eps, device, stream (K15 v2)
    "gqmap_edge_diff_v2_f32": [_P] * 6 + [_I] * 5 + [_D] * 2 + [_I, _P],
    "gqmap_edge_diff_v2_f64": [_P] * 6 + [_I] * 5 + [_D] * 2 + [_I, _P],
    # ptrs (27 device pointers), consts (19 doubles), node_form, edge_form, L, M, N, colour,
    # device, stream (kernels/sweep_update.site_update_cuda, K8)
    "gqmap_site_update_f32": [_P] * 2 + [_I] * 7 + [_P],
    "gqmap_site_update_f64": [_P] * 2 + [_I] * 7 + [_P],
    # ptrs (15 device pointers), consts (6 doubles), L, G, alpha_start, anneal_every, its, cap,
    # softmax_mode, device, stream (kernels/sweep_update.sweep_tail_cuda, K9)
    "gqmap_sweep_tail_f32": [_P] * 2 + [_I] * 8 + [_P],
    "gqmap_sweep_tail_f64": [_P] * 2 + [_I] * 8 + [_P],
    # ptrs, consts, ints, device, stream (kernels/sweep_update.site_update_cuda, K8 v2)
    "gqmap_site_update_v2_f32": [_P] * 3 + [_I, _P],
    "gqmap_site_update_v2_f64": [_P] * 3 + [_I, _P],
    # tab, out, mask, iters, blocks, device, stream (roofline.measure_ceilings)
    "gqmap_l1_load_f32": [_P] * 2 + [_I] * 4 + [_P],
    # out, iters, blocks, device, stream (roofline.measure_ceilings)
    "gqmap_mma_tf32": [_P] + [_I] * 3 + [_P],
    "gqmap_wgmma_tf32": [_P] + [_I] * 3 + [_P],
}


def _find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources() + _headers():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libgqmap_kernels_{h.hexdigest()[:16]}.so")


def _compile(nvcc: str, src: str, obj: str, timeout: float) -> str:
    """``nvcc -c`` of one source; returns its report headed by its seconds."""
    t = time.monotonic()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return (f"nvcc {os.path.basename(src)}: {time.monotonic() - t:.3f} s\n"
            + proc.stdout + proc.stderr)


def build_library(timeout: float = 900.0) -> tuple[str, bool]:
    """Compile the kernels if needed. Returns ``(path, built)``; ``built`` is
    False when the library for these sources already existed (cache hit)."""
    path = library_path()
    if os.path.exists(path):
        return path, False
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objdir = tempfile.mkdtemp(prefix=".obj_", dir=BUILD_DIR)
    try:
        srcs = _sources()
        objs = [os.path.join(objdir, os.path.basename(s)[:-3] + ".o") for s in srcs]
        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
            report = list(pool.map(lambda so: _compile(nvcc, *so, timeout), zip(srcs, objs)))
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True, timeout=timeout)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n"
                               f"{link.stderr}")
        with open(path[:-3] + ".log", "w") as f:
            f.write("".join(report))
        os.replace(tmp, path)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, True


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's ``argtypes``/``restype`` declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.gqmap_error_string.argtypes = [ctypes.c_int]
    lib.gqmap_error_string.restype = ctypes.c_char_p
    return lib


def require_capability(capability, device_name: str = "the device") -> None:
    """Raise unless ``capability`` (major, minor) is :data:`CAPABILITY`: the
    library holds ``sm_90a`` code only, which no other device can run."""
    if tuple(capability) != CAPABILITY:
        raise RuntimeError(
            f"the gqmap CUDA kernels are built for sm_90a (compute capability "
            f"{CAPABILITY[0]}.{CAPABILITY[1]}, Hopper) only; {device_name} has compute "
            f"capability {capability[0]}.{capability[1]}. Run on a Hopper card, or on the "
            "CPU (device='cpu'), where the plain PyTorch versions run")


@functools.lru_cache(maxsize=None)
def _check_device(index: int) -> None:
    require_capability(torch.cuda.get_device_capability(index),
                       f"cuda:{index} ({torch.cuda.get_device_name(index)})")


def library_for(device: torch.device) -> ctypes.CDLL:
    """The kernel library for a launch on the CUDA ``device``, after checking
    (once a device) that its compute capability can run it."""
    _check_device(torch.cuda.current_device() if device.index is None else device.index)
    return load_library()


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = load_library().gqmap_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def check_operands(name: str, like: torch.Tensor, named) -> None:
    """Raise unless ``like`` is a float32 or float64 CUDA tensor and every
    ``(what, x, shape)`` of ``named`` has that shape, ``like``'s device and
    dtype, and is contiguous."""
    if like.device.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {like.device}")
    if like.dtype not in _NP_DTYPES:
        raise TypeError(f"{name} takes float32 or float64, not {like.dtype}")
    for what, x, shape in named:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.device != like.device or x.dtype != like.dtype:
            raise ValueError(f"{what} must share the state's device and dtype")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


@functools.lru_cache(maxsize=None)
def _rule_host(values, K: int, dtype: torch.dtype) -> np.ndarray:
    """``values(K, dtype)`` on the host, kept alive by the cache."""
    return np.ascontiguousarray(values(K, _NP_DTYPES[dtype]))


@functools.lru_cache(maxsize=None)
def _rule_dev(values, K: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values(K, dtype)`` on the device, kept alive by the cache."""
    return torch.as_tensor(values(K, _NP_DTYPES[dtype]), device=device)


# the most shared memory a generic rule instance stages its rule into
# (csrc/rule_instance.cuh kRuleSharedBytes: the static launch limit)
RULE_SHARED_BYTES = 48 * 1024


def rule_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether a generic instance's rule of ``n`` values of ``dtype`` fits
    its shared memory (:data:`RULE_SHARED_BYTES`)."""
    return n * (4 if dtype == torch.float32 else 8) <= RULE_SHARED_BYTES


def rule_args(values, K: int, specialised, generic: bool, like: torch.Tensor):
    """The rule of a kernel with rule instances (K3, K10, K11, K14 v2):
    ``(held, rule_host, rule_dev)``. ``values(K, numpy dtype)`` gives the
    rule's values in the order the kernel reads them. For K in
    ``specialised`` (and ``generic`` false) ``rule_host`` points at them on
    the host, which selects the instance compiled for K (the launch copies
    them into its parameters); otherwise ``rule_dev`` points at them on
    ``like``'s device, which selects the generic instance. ``held`` is the
    array or tensor pointed at: the caller keeps it until the launch has
    read it."""
    if generic or K not in specialised:
        held = _rule_dev(values, K, like.dtype, like.device)
        return held, None, held.data_ptr()
    held = _rule_host(values, K, like.dtype)
    return held, held.ctypes.data, None
