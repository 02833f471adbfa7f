"""gqmap_tpu_torch: the GQMAP engine in PyTorch, with hand-written CUDA kernels.

The port of ``gqmap_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
It mirrors the JAX package's layout (``ops/``, ``kernels/``, ``models/``,
``io/``, ``cli/``) and never imports JAX; the JAX package is the reference
its tests compare with. It runs the ``GQMAPConfig.tpu_fast()`` main path,
the reference-parity ``GQMAPConfig.full_mixture()`` exact path, the super
lattice and the legacy families (``legacy_v1`` .. ``v3``, ``blockmatch_v2``
with ``models.blockmatch.block_matching_init``); the CUDA kernels
(``csrc/*.cu``) are built with ``nvcc`` at first use on the GPU.

The drivers: ``models.ctf.solve_coarse_to_fine`` (the coarse-to-fine
pyramid, ``ctf_level`` per level), ``models.param_sweep.sweep_lambdas``
(the lambda_s grid search), and ``io`` (``.flo`` files, MATLAB-parity
``rgb2gray``/``imresize``, the Middlebury registry ``load_sequence``, the
structure-texture preprocessing). The command line,
``python -m gqmap_tpu_torch.cli.main {run,suite,ctf,sweep}``, runs on the
GPU by default and on the CPU with ``--device cpu``.
"""

from .config import FlowRange, GQMAPConfig
from .models.gqmap import GQState, SolveResult, solve

__version__ = "0.1.0"

__all__ = ["GQMAPConfig", "FlowRange", "GQState", "SolveResult", "solve"]
