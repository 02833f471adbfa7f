"""Process-group launch for the multi-device solve.

Port of ``gqmap_tpu/parallel/launch.py``. The port runs one process a
device: start the same program on every rank, with
``python -m torch.distributed.run --nproc-per-node N ...`` (which sets the
rank, world size and rendezvous address in the environment) or with the
address, world size and rank given to :func:`initialize`, and call
:func:`initialize` first. The sweep sees only the mesh.

The backend follows from where the ranks run and has no option:

* NCCL when every rank of a host has a card of its own;
* gloo when ranks share a card (more ranks on the host than cards) or run on
  the CPU. NCCL refuses two ranks of one communicator on one card. Under
  gloo the halo slices and the summed scalars of CUDA tensors are staged
  through pinned host buffers (:mod:`gqmap_tpu_torch.parallel.halo`).

The choice is printed once. A group that cannot be formed raises; there is
no single-process fallback.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["initialize", "global_mesh", "host_to_global", "pick_backend"]

_TIMEOUT = datetime.timedelta(seconds=300)


def pick_backend(local_world_size: int, device_count: int, on_cpu: bool) -> str:
    """``"nccl"`` where every rank of the host has a card of its own, else
    ``"gloo"`` (ranks sharing a card, or on the CPU)."""
    if on_cpu or device_count == 0 or local_world_size > device_count:
        return "gloo"
    return "nccl"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None) -> int:
    """Form the process group and return the world size (1, and nothing
    formed, for one process).

    With no arguments the rank, world size and rendezvous come from the
    environment that ``torch.distributed.run`` sets; else from the arguments
    (``coordinator_address`` as ``host:port``). ``device`` is the run's
    device (``"cpu"`` for a CPU run; default the GPU where there is one): on
    the GPU each rank takes card ``local_rank % device_count`` as its
    current device.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    if world <= 1 and not coordinator_address:
        return 1
    rank = int(process_id if process_id is not None else env["RANK"])
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    on_cpu = (torch.device(device).type == "cpu" if device is not None
              else not torch.cuda.is_available())
    n_cards = 0 if on_cpu else torch.cuda.device_count()
    backend = pick_backend(local_world, n_cards, on_cpu)
    if not on_cpu:
        torch.cuda.set_device(local_rank % n_cards)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=_TIMEOUT)
    if rank == 0:
        why = ("the ranks run on the CPU" if on_cpu else
               f"{local_world} ranks share {n_cards} card(s) on this host"
               if backend == "gloo" else f"each of the {local_world} ranks has a card")
        print(f"gqmap_tpu_torch.parallel: backend {backend} ({why}), world size {world}",
              flush=True)
    return world


def global_mesh(dp: int = 1) -> Mesh:
    """The ``(dp, x, y)`` mesh over every rank of the job."""
    return make_mesh(dp=dp)


def _block(x, spec, mesh: Mesh):
    """This rank's block of ``x`` under ``spec`` (see :mod:`.mesh`)."""
    if x is None or not spec:
        return x
    if hasattr(spec, "_fields"):  # a NamedTuple of specs
        return type(x)(*(_block(getattr(x, f), getattr(spec, f), mesh) for f in spec._fields))
    x = torch.as_tensor(x)
    if x.ndim != len(spec):
        raise ValueError(f"spec {spec} does not fit a tensor of shape {tuple(x.shape)}")
    coords = dict(zip(mesh.axis_names, mesh.coords))
    for axis, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.shape[name]
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of shape {tuple(x.shape)} not divisible by mesh "
                             f"axis {name!r} of size {n}")
        size = x.shape[axis] // n
        x = x.narrow(axis, coords[name] * size, size)
    return x.contiguous()


def host_to_global(tree, spec, mesh: Mesh):
    """Each rank's block of identical per-rank data. ``tree`` holds the whole
    value of every leaf on every rank (which is how the solver builds its
    problem and state: a deterministic seeded init), ``spec`` the matching
    NamedTuple of specs (:func:`gqmap_tpu_torch.parallel.sharded.problem_sharding`,
    :func:`gqmap_tpu_torch.parallel.mesh.state_sharding`); each rank keeps
    its own block, made contiguous."""
    return _block(tree, spec, mesh)
