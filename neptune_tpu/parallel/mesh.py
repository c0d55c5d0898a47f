"""Device meshes for domain decomposition.

The reference has no distributed execution at all (every PETSc object lives on
PETSC_COMM_SELF — SURVEY.md §2.8); this layer is the new first-class
capability: PDE grids sharded over a `jax.sharding.Mesh`, with halo widths
derived from the verifier's stencil reach analysis.

Two cooperating paths (the scaling-book recipe):
  * **GSPMD** (default): annotate field shardings and let XLA insert the
    halo collective-permutes and reduction all-reduces. Used by the jnp
    executor, the Krylov/Newton solvers (whose tdot/psum reductions become
    all-reduces automatically), and the multi-chip dryrun.
  * **shard_map** (`neptune_tpu.parallel.halo`, `sharded_apply`, `ca_*`):
    explicit per-shard halo exchange via `lax.ppermute`, where the exchange
    schedule is part of the algorithm (fused strips, K-deep ghost zones).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


class GridMesh:
    """A device mesh aligned with leading grid dimensions.

    axis_names[d] shards grid dimension d; trailing grid dims beyond the mesh
    rank stay unsharded, so the innermost (contiguous) dimension keeps whole
    rows on each device.
    """

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Optional[Sequence[str]] = None,
        devices=None,
        abstract: bool = False,
    ):
        shape = tuple(int(s) for s in shape)
        if axis_names is None:
            axis_names = tuple(f"d{i}" for i in range(len(shape)))
        axis_names = tuple(axis_names)
        if len(axis_names) != len(shape):
            raise ValueError("axis_names / mesh shape rank mismatch")
        if abstract:
            # topology-only mesh (jax.sharding.AbstractMesh): enough for
            # plan_opdef/plan_report and jit sharding specification —
            # capacity-plan a pod slice without owning the devices. shard()
            # and execution naturally fail (no devices to put data on).
            from jax.sharding import AbstractMesh

            self.mesh = AbstractMesh(shape, axis_names)
        else:
            devices = list(devices) if devices is not None else jax.devices()
            need = math.prod(shape)
            if len(devices) < need:
                raise ValueError(
                    f"mesh {shape} needs {need} devices, have {len(devices)}"
                )
            dev_array = np.array(devices[:need]).reshape(shape)
            self.mesh = Mesh(dev_array, axis_names)
        self.axis_names = axis_names
        self.shape = shape

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def pspec(self, grid_rank: int) -> PartitionSpec:
        """PartitionSpec sharding the first len(axis_names) grid dims."""
        entries = list(self.axis_names[:grid_rank])
        entries += [None] * (grid_rank - len(entries))
        return PartitionSpec(*entries)

    def sharding(self, grid_rank: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.pspec(grid_rank))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, PartitionSpec())

    def shard(self, array):
        """Place a grid array onto the mesh (sharded along leading dims)."""
        return jax.device_put(array, self.sharding(array.ndim))

    def check_divisible(self, grid_shape: Sequence[int]):
        for d, (g, m) in enumerate(zip(grid_shape, self.shape)):
            if g % m != 0:
                raise ValueError(
                    f"grid dim {d} extent {g} not divisible by mesh axis "
                    f"{self.axis_names[d]} size {m}"
                )


def single_device_mesh() -> GridMesh:
    return GridMesh((1,), ("x",), devices=jax.devices()[:1])
