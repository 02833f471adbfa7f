"""Hand-written CUDA kernels of the port, with their wrappers and plain versions.

:data:`COUNTED` lists the wrappers that count their launches (each adds one
to its ``launches`` where it launches its kernel), so a caller that replays
captured launches can keep the counts without knowing the kernels:
K1-K7, K8, K9 v1, K9 v2 (``sweep_tail_v2`` counts its tails, which run
inside K8 v2's launches), K10, K11, K12 and the autodiff estimator's K13,
K14, K15 and K16.
"""

from .autodiff_gq import (edge_chain_gq_cuda, edge_diff_adjoint_cuda, node_chain_gq_cuda,
                          node_window_chain_gq_cuda)

from .cheb_gq import cheb_gq_cuda
from .cosine_gq import cos_mode_sums_cuda
from .edge_gq import edge_gq_cuda
from .edge_reduced_gq import edge_reduced_grads_cuda
from .nearest_gq import nearest_chain_gq_cuda, nearest_gq_cuda
from .node_gq import node_gq_cuda
from .quad_gq import quad_node_gq_cuda, truncquad_edge_gq_cuda
from .sweep_update import site_update_cuda, sweep_tail_cuda, sweep_tail_v2
from .window_gq import node_window_gq_cuda

COUNTED = (cos_mode_sums_cuda, edge_reduced_grads_cuda, edge_gq_cuda, node_gq_cuda,
           cheb_gq_cuda, nearest_gq_cuda, nearest_chain_gq_cuda, site_update_cuda,
           sweep_tail_cuda, sweep_tail_v2, quad_node_gq_cuda, truncquad_edge_gq_cuda,
           node_window_gq_cuda, node_chain_gq_cuda, edge_chain_gq_cuda, edge_diff_adjoint_cuda,
           node_window_chain_gq_cuda)
