"""Kernel K1: the six cosine mode sums of the node term, on the card.

Counterpart of ``gqmap_tpu/kernels/cosine_gq.py`` (``cos_mode_sums_pallas``)
and its three variants: ``"v1"`` (full A x B sum), ``"adaptive"`` (u-degree
cutoff below e^-50) and ``"recur"`` (cutoff plus the exp-free recurrence
body where it is safe), ``"recur"`` by default. The CUDA kernel is
``gqmap_tpu_torch/csrc/cosine_gq.cu``; its plain PyTorch version is
:func:`gqmap_tpu_torch.ops.cosine._mode_sums`, re-exported here as
:func:`cos_mode_sums_torch`. The plain version is always the full sum: the
variants differ from it only at rounding level.

* :func:`cos_mode_sums_cuda` launches the kernel (and raises for tensors that
  are not on a CUDA device); ``cos_mode_sums_cuda.launches`` counts its
  launches. The kernel is compiled for 1 to :data:`MAX_L` components; more
  run as :func:`component_groups`, a launch a group (:func:`by_groups`), so
  K1 takes any L, as the JAX kernel does.
* :func:`cos_mode_sums` launches the kernel for CUDA tensors and runs the
  plain version for CPU tensors, whatever the variant.

The six sums are the exact gradient of the closed-form expectation
``ops.cosine.cos_ei`` (``_finalize_mode_sums`` with ``a = 1``, ``T = 0``):
:func:`cos_ei_adjoint` is ``cos_ei`` as a ``torch.autograd.Function`` whose
forward is one launch of K1 and whose backward scales the saved gradients,
the autodiff estimator's cosine term.
"""

from __future__ import annotations

import math

import torch

from ..ops.cosine import CosData, _finalize_mode_sums
from ..ops.cosine import _mode_sums as cos_mode_sums_torch
from ..ops.gq import NODE
from . import build
from .autodiff_gq import Partials

__all__ = ["by_groups", "component_groups", "cos_ei_adjoint", "cos_mode_sums",
           "cos_mode_sums_cuda", "cos_mode_sums_torch", "phase_stack", "MAX_L", "VARIANTS"]

MAX_L = 4  # mixture components a launch takes (the instances of csrc/cosine_gq.cu)
VARIANTS = ("v1", "adaptive", "recur")  # kernel codes 0, 1, 2
_DEFAULT_VARIANT = "recur"


def _variant_code(variant: str | None) -> int:
    variant = _DEFAULT_VARIANT if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown cosine kernel variant {variant!r}")
    return VARIANTS.index(variant)


def component_groups(L: int, most: int = MAX_L) -> list[tuple[int, int]]:
    """``(l0, n)`` of the fewest groups of at most ``most`` consecutive
    components that cover ``L``, sized as evenly as possible, the larger
    first (L = 5: 3 + 2; L = 9: 3 + 3 + 3)."""
    if L < 1:
        raise ValueError(f"K1 takes L >= 1 components, got L={L}")
    count = -(-L // most)
    size, extra = divmod(L, count)
    groups, l0 = [], 0
    for k in range(count):
        n = size + (k < extra)
        groups.append((l0, n))
        l0 += n
    return groups


def by_groups(sums, out: torch.Tensor) -> tuple:
    """The six ``(L, M, N)`` sums of ``out`` (``(6, L, M, N)``), filled by
    ``sums(l0, n, part)`` once a :func:`component_groups` group, ``part``
    being ``out[:, l0:l0 + n]``: each group's sums depend on its own
    components alone (its cutoff statistics too)."""
    for l0, n in component_groups(out.shape[1]):
        sums(l0, n, out[:, l0:l0 + n])
    return tuple(out.unbind(0))


def phase_stack(cos: CosData, u1, u2, o1, o2, p) -> torch.Tensor:
    """K1's input: the phases and scales ``(ku (u1 - lo_u), kv (u2 - lo_v), ku
    o1, kv o2, p)`` of ``(L, M, N)`` sites as one ``(5, L, M, N)`` tensor."""
    ku = math.pi / (cos.hi_u - cos.lo_u)
    kv = math.pi / (cos.hi_v - cos.lo_v)
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    return torch.stack([x.expand(site) for x in
                        (ku * (u1 - cos.lo_u), kv * (u2 - cos.lo_v), ku * o1, kv * o2, p)])


def cos_mode_sums_cuda(cos: CosData, u1, u2, o1, o2, p, variant: str | None = None,
                       counters: torch.Tensor | None = None, stack: torch.Tensor | None = None):
    """Kernel K1 on ``(L, M, N)`` site tensors and ``(A, B, M, N)`` coefficients.

    Computes the phases and scales (``ph = k (mu - lo)``, ``s = k sigma``) in
    torch, stacks them as one ``(5, L, M, N)`` input (:func:`phase_stack`; or
    takes ``stack``, that input as given, which K8 v2 carries from the last
    sweep) and returns the six
    ``(L, M, N)`` sums ``(E0, A1, A2, Aa, Ab, Ax)``. ``variant`` is one of
    :data:`VARIANTS` (None: ``"recur"``). ``counters``, if given, is an int64
    tensor of 3 on the same device that the kernel adds to: warps (32-site
    tiles) that ran the recur body, warps that ran the exp body, modes
    evaluated. Above :data:`MAX_L` components, one launch a
    :func:`component_groups` group, each reading its slice of the stack and
    writing its slice of the sums in place, its cutoff statistics over its
    own components (the warps of every group counted): the result differs
    from one launch's only below the e^-50 tail.
    """
    code = _variant_code(variant)
    coeffs = cos.coeffs
    if coeffs.device.type != "cuda":
        raise RuntimeError("cos_mode_sums_cuda needs CUDA tensors; "
                           f"the coefficient field is on {coeffs.device}")
    if coeffs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cos_mode_sums_cuda takes float32 or float64, not {coeffs.dtype}")
    if coeffs.ndim != 4 or not coeffs.is_contiguous():
        raise ValueError(f"coefficients must be a contiguous (A, B, M, N) tensor, "
                         f"got shape {tuple(coeffs.shape)}")
    A, B, M, N = coeffs.shape
    for x in (u1, u2, o1, o2, p):
        if x.device != coeffs.device or x.dtype != coeffs.dtype:
            raise ValueError("site tensors must share the coefficients' device and dtype")
    site = torch.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    if len(site) != 3 or tuple(site[1:]) != (M, N):
        raise ValueError(f"site shape {tuple(site)} is not (L, {M}, {N})")
    L = site[0]
    component_groups(L)  # raises for L < 1
    if counters is not None and (counters.device != coeffs.device
                                 or counters.dtype != torch.int64
                                 or counters.shape != (3,) or not counters.is_contiguous()):
        raise ValueError("counters must be a contiguous int64 tensor of 3 on the "
                         "coefficients' device")

    if stack is None:
        sp = phase_stack(cos, u1, u2, o1, o2, p)
    else:
        if (tuple(stack.shape) != (5,) + tuple(site) or stack.dtype != coeffs.dtype
                or stack.device != coeffs.device or not stack.is_contiguous()):
            raise ValueError(f"stack must be a contiguous (5, {L}, {M}, {N}) tensor of the "
                             "coefficients' type and device")
        sp = stack
    out = torch.empty((6, L, M, N), dtype=coeffs.dtype, device=coeffs.device)
    lib = build.library_for(coeffs.device)
    fn = (lib.gqmap_cos_mode_sums_f32 if coeffs.dtype == torch.float32
          else lib.gqmap_cos_mode_sums_f64)
    stream = torch.cuda.current_stream(coeffs.device).cuda_stream

    def launch(l0, n, part):
        build.check(fn(sp[:, l0].data_ptr(), coeffs.data_ptr(), part.data_ptr(),
                       None if counters is None else counters.data_ptr(), n, L, M * N, A, B,
                       code, coeffs.device.index, stream), "cos_mode_sums_cuda")
        cos_mode_sums_cuda.launches += 1

    return by_groups(launch, out)


cos_mode_sums_cuda.launches = 0


def cos_mode_sums(cos: CosData, u1, u2, o1, o2, p, variant: str | None = None,
                  stack: torch.Tensor | None = None):
    """Kernel K1 for CUDA tensors, its plain version (the full sum, whatever
    the variant, from the state: ``stack`` is K1's input only) for CPU
    tensors."""
    _variant_code(variant)
    if cos.coeffs.device.type == "cpu":
        return cos_mode_sums_torch(cos, u1, u2, o1, o2, p)
    return cos_mode_sums_cuda(cos, u1, u2, o1, o2, p, variant, stack=stack)


def cos_ei_adjoint(cos: CosData, u1, u2, o1, o2, p, sums=cos_mode_sums) -> torch.Tensor:
    """``ops.cosine.cos_ei`` differentiable in its five site inputs, from one
    call of ``sums`` (K1's mode sums by :func:`cos_mode_sums`, or a route of
    them): the value is ``_finalize_mode_sums``' ``da`` at ``a = 1``, ``T =
    0``, and its saved gradients ``du1 .. dp`` are the value's exact
    derivatives (``tests/test_cosine.py`` holds them to ``jax.grad``)."""
    def fn(*site):
        g = _finalize_mode_sums(cos, sums(cos, *site), site[0], site[2], site[3], site[4],
                                1.0, 0.0, NODE)
        return g.da, (g.du1, g.du2, g.do1, g.do2, g.dp)

    return Partials.apply(fn, u1, u2, o1, o2, p)
