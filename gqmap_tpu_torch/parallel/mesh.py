"""The ``(dp, x, y)`` grid of ranks and the specs of the lattice's blocks.

Port of ``gqmap_tpu/parallel/mesh.py``. Parallelism axes (SURVEY.md section
2.5):

* ``dp`` -- data parallelism over frames or sequences (the reference's
  sequential driver loop, ``optical_flow.m:5``, as a batch axis);
* ``x`` / ``y`` -- 2-D block sharding of the flow lattice over the ranks of
  one ``dp`` index: each rank owns an ``(M / x, N / y)`` block, its ring
  neighbours along ``x`` and ``y`` hold the rows and columns next to it.

A JAX mesh is a grid of devices under one program; here it is a grid of
processes (one a device, ``torch.distributed`` ranks), rank ``r`` at
``(d, i, j)`` with ``r = (d x + i) y + j``. Its shape logic needs no process
group, so it works as a plain function; the process subgroups (the ``(x,
y)`` ranks of each ``dp`` index, over which the sweep's scalars are summed)
are formed on first use, by every rank of the job together.

A spec is a tuple with one entry an axis of a tensor: ``"dp"``, ``"x"`` or
``"y"`` where that axis is split over the mesh axis of that name, None where
it is whole; ``()`` (:func:`replicated`) leaves the whole value on every
rank. Frames stay whole: every node's bounded-range lookup may touch an
arbitrary window of frame 2.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..models.gqmap import GQState

__all__ = ["Mesh", "Ring", "make_mesh", "make_mesh_for_shape", "state_sharding", "factor_2d",
           "replicated"]


def factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization n = a*b with a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


class Ring(NamedTuple):
    """The ranks around one rank along one mesh axis: ``n`` shards, the rank
    before it (``prev``) and after it (``next``), with wrap."""

    n: int
    prev: int
    next: int


class Mesh:
    """A ``(dp, x, y)`` grid of ranks and this process's place in it.

    ``shape`` maps each of ``axis_names`` to its size, and ``devices`` is the
    grid of ranks (as the JAX mesh's grid of devices). ``rank`` is this
    process's rank (None where it is outside the grid), ``coords`` its
    ``(d, i, j)``.
    """

    axis_names = ("dp", "x", "y")

    def __init__(self, dp: int, x: int, y: int, rank: int | None = 0):
        self.devices = np.arange(dp * x * y).reshape(dp, x, y)
        self.shape = dict(zip(self.axis_names, (dp, x, y)))
        self.rank = rank if rank is not None and rank < self.devices.size else None
        self._groups = None

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def coords(self) -> tuple[int, int, int]:
        if self.rank is None:
            raise ValueError(f"this process is outside the mesh {self.shape}")
        d, i, j = np.unravel_index(self.rank, self.devices.shape)
        return int(d), int(i), int(j)

    def block(self, M: int, N: int) -> tuple[int, int]:
        """This rank's block of an ``(M, N)`` lattice; raises where the mesh
        does not divide it."""
        px, py = self.shape["x"], self.shape["y"]
        if M % px or N % py:
            raise ValueError(f"lattice {(M, N)} not divisible by mesh {(px, py)}")
        return M // px, N // py

    def origin(self, M: int, N: int) -> tuple[int, int]:
        """The lattice offset (row, column) of this rank's block of an ``(M, N)``
        lattice."""
        ml, nl = self.block(M, N)
        _, i, j = self.coords
        return i * ml, j * nl

    def ring(self, axis: str) -> Ring:
        """This rank's neighbours along mesh axis ``"x"`` or ``"y"``."""
        d, i, j = self.coords
        px, py = self.shape["x"], self.shape["y"]
        if axis == "x":
            return Ring(px, int(self.devices[d, (i - 1) % px, j]),
                        int(self.devices[d, (i + 1) % px, j]))
        if axis == "y":
            return Ring(py, int(self.devices[d, i, (j - 1) % py]),
                        int(self.devices[d, i, (j + 1) % py]))
        raise ValueError(f"unknown lattice axis {axis!r}")

    def xy_group(self):
        """The process subgroup of this rank's ``dp`` index. Every rank of the
        job forms all ``dp`` subgroups together on its first call, so every
        rank must call it (the sweep does, in its first reduction)."""
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "the mesh has no process group: start one process a device with "
                "`python -m torch.distributed.run --nproc-per-node N ...` and call "
                "gqmap_tpu_torch.parallel.initialize() before the sweep")
        if dist.get_world_size() < self.devices.size:
            raise ValueError(f"the mesh {self.shape} needs {self.devices.size} ranks, the "
                             f"process group has {dist.get_world_size()}")
        if self._groups is None:
            self._groups = [dist.new_group([int(r) for r in self.devices[d].reshape(-1)])
                            for d in range(self.shape["dp"])]
        return self._groups[self.coords[0]]


def _rank(rank):
    if rank is not None:
        return rank
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _world(n_devices):
    if n_devices is not None:
        return n_devices
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, dp: int = 1, rank: int | None = None) -> Mesh:
    """Build a ``(dp, x, y)`` mesh over the first ``n_devices`` ranks
    (default: the world size, 1 without a process group); ``rank`` defaults
    to this process's."""
    n_devices = _world(n_devices)
    if n_devices % dp:
        raise ValueError(f"dp={dp} does not divide n_devices={n_devices}")
    x, y = factor_2d(n_devices // dp)
    return Mesh(dp, x, y, _rank(rank))


def make_mesh_for_shape(M: int, N: int, n_devices: int | None = None, dp: int = 1,
                        rank: int | None = None) -> Mesh:
    """Largest ``(dp, x, y)`` mesh with ``x | M`` and ``y | N``.

    The sharded lattice dims must divide evenly; this picks the maximal
    divisor pair fitting the device budget (spare ranks are left out of the
    mesh rather than failing: on them ``Mesh.rank`` is None).
    """
    budget = _world(n_devices) // dp
    best = (1, 1)
    for x in range(1, min(M, budget) + 1):
        if M % x:
            continue
        y = budget // x
        while y > 1 and N % y:
            y -= 1
        if x * y > best[0] * best[1]:
            best = (x, y)
    return Mesh(dp, *best, _rank(rank))


def state_sharding(mesh: Mesh | None = None, batched: bool = False) -> GQState:
    """The spec of every GQState field (optionally with a leading batch axis
    split over ``dp``): the lattice axes ``(M, N)`` trail."""
    lead = ("dp",) if batched else ()

    def s(*dims):
        return lead + dims

    return GQState(
        w=s(None),
        muu=s(None, "x", "y"),
        muv=s(None, "x", "y"),
        sigmau=s(None, "x", "y"),
        sigmav=s(None, "x", "y"),
        pn=s(None, "x", "y"),
        rou=s(None, None, None, "x", "y"),
        temperature=s(),
        it=s(),
    )


def replicated(mesh: Mesh | None = None) -> tuple:
    """The spec of a value every rank holds whole."""
    return ()
