"""Mesh-sharded GQMAP sweeps: each rank's blocks and its sweep.

Port of ``gqmap_tpu/parallel/sharded.py``. The JAX package has two
mechanisms: this module's GSPMD path (jit the single-device sweep with
NamedShardings and let XLA's partitioner insert the halos and psums) and
the explicit halo sweep of ``parallel/halo.py``. PyTorch has no partitioner
that could see through the port's hand-written kernels, so the port has one
mechanism, the explicit halo sweep on ``torch.distributed`` (one process a
device), and :func:`make_sharded_sweep` builds that same sweep. Its
arguments are this rank's blocks (:func:`shard_problem`,
:func:`shard_state`), where the JAX function takes the global arrays.

The frames stay whole on every rank (~1 MB at Middlebury scale; a node's
bounded-range lookup may touch any window of frame 2). The spectral
coefficient field (cosine or Chebyshev), (A, B, M, N), the dominant per-run
constant, is strictly per site and block-shards with the lattice, as do the interior mask and the
quadratic prior's init flow: each rank builds the whole field and keeps its
contiguous block.
"""

from __future__ import annotations

import torch

from ..config import GQMAPConfig
from ..models.gqmap import GQState, Problem, SweepAux
from ..ops.chebyshev import ChebData, site_major
from ..ops.cosine import CosData
from .halo import all_gather_blocks, make_halo_sweep
from .launch import host_to_global
from .mesh import Mesh, state_sharding

__all__ = [
    "problem_sharding",
    "make_sharded_sweep",
    "make_batched_sharded_sweep",
    "shard_state",
    "shard_problem",
    "stack_states",
    "gather_state",
]


def _cheb_cls(data_term: str):
    """The coefficient field's record for ``data_term`` (None: it has none)."""
    return {"chebyshev": ChebData, "cosine": CosData}.get(data_term)


def problem_sharding(mesh: Mesh | None = None, cfg: GQMAPConfig | None = None) -> Problem:
    """The spec of every Problem field: the frames, Prewitt fields and pads whole,
    the interior mask, the coefficient field's lattice axes (the record of
    ``cfg.data_term``; without ``cfg`` the cosine one, whose fields are the
    Chebyshev one's) and the init flow's split over ``(x, y)``."""
    cls = CosData if cfg is None else _cheb_cls(cfg.data_term)
    return Problem(I1=(), I2_tab=(), interior=("x", "y"), rng=(),
                   cheb=None if cls is None else cls((None, None, "x", "y"), (), (), (), ()),
                   init_flow=("x", "y", None), grad_tabs=(), nearest_pads=())


def shard_problem(problem: Problem, mesh: Mesh) -> Problem:
    """This rank's block of every per-run constant (:func:`problem_sharding`);
    a Chebyshev field's block is stored site major, as ``build_cheb_data``
    stores the whole one."""
    local = host_to_global(problem, problem_sharding(mesh), mesh)
    if isinstance(local.cheb, ChebData):
        local = local._replace(cheb=local.cheb._replace(coeffs=site_major(local.cheb.coeffs)))
    return local


def shard_state(state: GQState, mesh: Mesh, batched: bool = False) -> GQState:
    """This rank's block of ``state`` (with ``batched``, also its slice of the
    leading batch axis, split over ``dp``)."""
    return host_to_global(state, state_sharding(mesh, batched), mesh)


def gather_state(state: GQState, mesh: Mesh) -> GQState:
    """The whole state from every ``(x, y)`` rank's block (of this rank's
    ``dp`` index), on each of them: one ``all_gather``."""
    L = state.muu.shape[0]
    ml, nl = state.muu.shape[-2:]
    lattice = torch.cat([state.muu, state.muv, state.sigmau, state.sigmav, state.pn,
                         state.rou.reshape(4 * L, ml, nl)])
    whole = all_gather_blocks(lattice, mesh)
    M, N = whole.shape[-2:]
    muu, muv, su, sv, pn, rou = whole.split([L] * 5 + [4 * L])
    return state._replace(muu=muu, muv=muv, sigmau=su, sigmav=sv, pn=pn,
                          rou=rou.reshape(2, 2, L, M, N))


def make_sharded_sweep(cfg: GQMAPConfig, image_shape, mesh: Mesh):
    """The sweep of this rank's block, lattice block-sharded over ``(x, y)``:
    ``sweep(shard_problem(problem), shard_state(state))``
    (:func:`gqmap_tpu_torch.parallel.halo.make_halo_sweep`)."""
    return make_halo_sweep(cfg, image_shape, mesh)


def make_batched_sharded_sweep(cfg: GQMAPConfig, image_shape, mesh: Mesh):
    """A leading batch axis split over ``dp``, the lattice over ``(x, y)``:
    ``sweep(local_problem, local_batch)`` runs each state of this ``dp``
    index's slice of the batch (``shard_state(batch, mesh, batched=True)``)
    through the halo sweep of its ``(x, y)`` ranks and stacks the results
    (SweepAux fields of shape ``(B / dp,)``).

    This is the whole parallelism stack, data parallelism over sequences and
    2-D spatial decomposition, in one call on every rank."""
    sweep = make_halo_sweep(cfg, image_shape, mesh)

    def vsweep(problem: Problem, batch: GQState):
        outs = [sweep(problem, GQState(*(x[b] for x in batch)))
                for b in range(batch.muu.shape[0])]
        return (stack_states([o[0] for o in outs]),
                SweepAux(*(torch.stack(xs) for xs in zip(*(o[1] for o in outs)))))

    return vsweep


def stack_states(states: list[GQState]) -> GQState:
    """The states stacked along a new leading batch axis."""
    return GQState(*(torch.stack([torch.as_tensor(x) for x in xs]) for xs in zip(*states)))
