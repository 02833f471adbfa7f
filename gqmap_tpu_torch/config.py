"""Run configuration for the PyTorch port, field for field the JAX package's.

``GQMAPConfig`` and its presets mirror ``gqmap_tpu/config.py`` exactly, so a
configuration built in one package reproduces in the other (the CPU parity
tests compare every preset field by field). Two fields differ in meaning:

* ``node_kernel`` / ``edge_kernel`` take ``"auto" | "cuda" | "torch"``.
  ``"auto"`` launches the hand-written CUDA kernel for tensors on the GPU and
  runs its plain PyTorch version for tensors on the CPU; ``"cuda"`` always
  launches the kernel (and raises for CPU tensors); ``"torch"`` is the
  explicit plain path, the counterpart of the JAX package's ``"xla"``.
  ``edge_kernel`` picks the kernel of the configured ``edge_quad``: K2 for
  ``"reduced"``, K3 for ``"tensor"``. The JAX package keeps its tensor-rule
  kernel opt-in (``edge_kernel="pallas"``) for TPU cost reasons; here
  ``"auto"`` launches K3 on the GPU, whose sums differ from the plain
  version's only in summation order. ``node_kernel`` picks K1 for the
  cosine term, K4 for the bicubic term without a window and K5 for the
  Chebyshev term (at most 64 v-degrees; the JAX package's XLA scans of
  those two), under the Stein estimator; the other node terms are plain
  sums. Under the autodiff estimator the kernels K1, K13, K6, K14 and K15
  compute the terms ``models.gqmap.check_supported`` names, and
  ``"torch"`` is ``torch.autograd`` of the plain expectation.
* ``bicubic_pack`` is accepted and has no effect: it selects a TPU gather
  layout whose values differ from the 16-tap path only by summation order.

Which configurations the port runs so far is checked by
:func:`gqmap_tpu_torch.models.gqmap.check_supported`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

__all__ = ["GQMAPConfig", "FlowRange"]


class FlowRange(NamedTuple):
    """GT-derived clamp/init ranges (``optical_flow.m:12-13``)."""

    minu: float
    maxu: float
    minv: float
    maxv: float


@dataclasses.dataclass(frozen=True)
class GQMAPConfig:
    # --- model ---
    K: int = 9                    # Gauss-Hermite order
    L: int = 3                    # mixture components
    epsn: float = 1e-6            # Charbonnier epsilon
    lambdad: float = 1.0          # data weight
    lambdas: float = 5.0          # smoothness weight
    patch: int = 1                # flow node owns patch x patch image pixels
    data_term: str = "bicubic"    # "bicubic" | "nearest" | "chebyshev" | "cosine" | "quadratic"
    rfc: int = 6                  # upsample factor exponent for data_term="nearest"
    bicubic_pack: bool = True     # accepted, no effect in the port (module docstring)
    cheb_p: int = 96              # u-degree of the spectral data term
    cheb_q: int = 32              # v-degree
    cheb_margin: float = 2.0      # displacement-box margin beyond the flow range
    cheb_ablock: int = 8          # u-degrees per block of the JAX scan path
    node_kernel: str = "auto"     # K1 cosine, K4 bicubic, K5 chebyshev: "auto"|"cuda"|"torch"
    window_rg: int = 0            # overlapping data-cost window half-size
    quad_var: float = 1.0         # variance of the quadratic node prior
    edge_kind: str = "charbonnier"  # or "truncquad"
    edge_quad: str = "tensor"     # "tensor" (K^2 rule) | "reduced" (1-D rule)
    edge_quad_k: int = 0          # 1-D order for edge_quad="reduced"; 0 = 2K+3
    edge_kernel: str = "auto"     # edge term (K2 or K3): "auto" | "cuda" | "torch"
    gama: float = 1.0             # truncated-quadratic edge scale
    dta: float = 10.0             # truncation cutoff

    # --- annealing / entropy ---
    temperature: float = 0.0      # initial Bethe-entropy temperature T
    drate: float = 0.5            # geometric decay rate of T
    anneal_every: int = 0         # decay cadence in iters (0 = no annealing)
    t_floor: float = 1e-3         # T floor

    # --- optimization ---
    sweep_order: str = "jacobi"   # "jacobi" | "redblack"
    its: int = 30000              # max sweeps
    step0: float = 0.1            # step = step0 / (1 + it/step_tau)
    step_tau: float = 8000.0      # inf => constant step
    sigma_step_scale: float = 1.0
    sigma_min: float = 0.01
    sigma_max: float = 23.0
    corr_tor: float = 1.0 - 1e-5  # |rho| clamp
    border: int = 1               # frozen boundary ring
    tor: float = 1e-4             # convergence threshold on mean |dmu|

    # --- gradient estimator ---
    gradient_estimator: str = "stein"  # "stein" | "autodiff" | "prewitt"

    # --- mixture weights ---
    alpha_update: str = "softmax_natural"  # or "projsplx"
    alpha_start: int = 500        # first iteration the alpha update runs after
    alpha_lr_scale: float = 1e-7  # lr = step * alpha_lr_scale

    # --- evaluation / runtime ---
    eval_every: int = 300         # MAP/AEPE/logP cadence
    quad_chunk: int = 0           # quadrature points per step of the K^2 rule
    dtype: str = "float32"        # "float64" for the golden model
    seed: int = 0
    debug_finite: bool = False    # raise FloatingPointError on a non-finite state

    @property
    def step_const(self) -> bool:
        return math.isinf(self.step_tau)

    def step_at(self, it) -> float:
        if self.step_const:
            return self.step0
        return self.step0 / (1.0 + it / self.step_tau)

    # ------------------------------------------------------------------ presets
    @classmethod
    def full_mixture(cls, **kw) -> "GQMAPConfig":
        """Full-resolution L=3 mixture, T=0."""
        return cls(**{**dict(
            K=9, its=30000, epsn=1e-6, lambdas=5.0, lambdad=1.0, L=3,
            temperature=0.0, drate=0.5, anneal_every=0,
            step0=0.1, step_tau=8000.0, sigma_max=23.0, patch=1,
        ), **kw})

    @classmethod
    def super_entropy(cls, **kw) -> "GQMAPConfig":
        """Quarter-res super lattice + entropy annealing."""
        return cls(**{**dict(
            K=11, its=30000, epsn=1e-6, lambdas=16.0, lambdad=1.0, L=3,
            temperature=0.2, drate=0.75, anneal_every=500, t_floor=1e-3,
            step0=0.001, step_tau=4000.0, sigma_max=25.0, patch=4,
        ), **kw})

    @classmethod
    def single_gaussian(cls, **kw) -> "GQMAPConfig":
        """L=1 full-res solver."""
        return cls.full_mixture(**{**dict(L=1), **kw})

    @classmethod
    def tpu_fast(cls, **kw) -> "GQMAPConfig":
        """Flagship mixture preset: closed-form cosine data term at 64x16
        degrees and reduced 1-D edge quadrature (the port's main path)."""
        return cls.full_mixture(**{**dict(
            data_term="cosine", cheb_p=64, cheb_q=16, quad_chunk=27,
            edge_quad="reduced",
        ), **kw})

    @classmethod
    def tpu_fast_super(cls, **kw) -> "GQMAPConfig":
        """Super lattice + annealing on the cosine / reduced-edge paths."""
        return cls.super_entropy(**{**dict(
            data_term="cosine", cheb_p=96, cheb_q=16, quad_chunk=0,
            edge_quad="reduced",
        ), **kw})

    @classmethod
    def legacy_v1(cls, **kw) -> "GQMAPConfig":
        """Quadratic node prior + truncated-quadratic edges, L=1."""
        return cls(**{**dict(
            K=9, its=2000, L=1, data_term="quadratic", edge_kind="truncquad",
            quad_var=1.0, gama=1.0, dta=10.0,
            step0=0.1, step_tau=1000.0, corr_tor=0.97, sigma_max=25.0,
        ), **kw})

    @classmethod
    def legacy_v2(cls, **kw) -> "GQMAPConfig":
        """Windowed data cost, nearest lookup, L=1."""
        return cls.single_gaussian(**{**dict(
            data_term="nearest", rfc=6, window_rg=2, border=2,
            epsn=1e-4, tor=1e-3,
        ), **kw})

    @classmethod
    def legacy_v3(cls, **kw) -> "GQMAPConfig":
        """Prewitt image-gradient estimator, nearest lookup, L=1."""
        return cls.single_gaussian(**{**dict(
            data_term="nearest", rfc=4, gradient_estimator="prewitt",
            epsn=1e-4, tor=1e-2,
        ), **kw})

    @classmethod
    def blockmatch_v2(cls, **kw) -> "GQMAPConfig":
        """Block-matching-init experiment solver settings."""
        return cls.single_gaussian(**{**dict(
            K=17, its=5000, epsn=1e-4, lambdas=1.7, lambdad=0.3,
            data_term="nearest", rfc=6,
        ), **kw})

    @classmethod
    def ctf_level(cls, **kw) -> "GQMAPConfig":
        """Single pyramid-level solver: L=1, constant step 0.07."""
        return cls(**{**dict(
            K=11, its=3000, epsn=1e-6, lambdas=5.0, lambdad=1.0, L=1,
            temperature=0.0, anneal_every=0,
            step0=0.07, step_tau=math.inf, sigma_step_scale=0.3,
            sigma_max=25.0, corr_tor=0.999, patch=1,
        ), **kw})
