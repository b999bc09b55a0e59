"""Device-mesh + sharding helpers.

The reference delegated distribution to HF Accelerate's DDP wrapper
(diffusion.py:456-458, 567-586) — gradient all-reduce over NCCL with
host-side barriers. Here it is a single jax.Array program: a 'dp' mesh
over the cards of a host (plus an outer 'dcn' axis across processes
when the multi-controller runtime is active, parallel/distributed.py),
batches sharded along ('dcn','dp'), params replicated; XLA inserts the
gradient psum during jit compilation and lowers it to an NCCL
all-reduce on GPUs. No user-visible collectives, no barriers. The cards
of a host are joined all to all, so the mesh needs no topology.

The model here is small (1e7-1e8 params, images <= 512^2), so data
parallelism is the only distribution the workload needs (SURVEY.md §2,
"Parallelism strategies"); the mesh helper still accepts extra axes so
larger variants can shard parameters ('tp') without API changes.
"""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp",),
    dcn_size: Optional[int] = None,
) -> Mesh:
    """Build the device mesh.

    ``dcn_size=None`` auto-detects: one mesh axis when the process is
    alone, an outer ('dcn', ...) axis of size
    ``jax.process_count()`` under the multi-controller runtime (the
    reference's multi-node Accelerate launch, diffusion.py:456-458).
    Pass ``dcn_size`` explicitly to exercise the hybrid layout on a
    single process (tests do this on the virtual CPU mesh).
    """
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if dcn_size is None:
        dcn_size = jax.process_count() if jax.process_count() > 1 else 1

    if dcn_size > 1:
        assert n % dcn_size == 0, (
            f"{n} devices do not divide over dcn_size={dcn_size}"
        )
        per = n // dcn_size
        if jax.process_count() == dcn_size and n == len(devices):
            # real multi-host: 'dp' neighbours share a process and only
            # the outer 'dcn' axis crosses processes
            by_proc = sorted(devices, key=lambda d: (d.process_index, d.id))
            dev_grid = np.asarray(by_proc).reshape(dcn_size, per)
        else:
            dev_grid = np.asarray(devices[:n]).reshape(dcn_size, per)
        names = ("dcn",) + tuple(axis_names)
        if len(axis_names) > 1:
            dev_grid = dev_grid.reshape(
                (dcn_size, per) + (1,) * (len(axis_names) - 1)
            )
        return Mesh(dev_grid, names)

    devices = np.asarray(devices[:n])
    if len(axis_names) == 1:
        shape = (n,)
    else:
        # fold extra axes as size-1 unless the caller reshapes explicitly
        shape = (n,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def _batch_axes(mesh: Mesh):
    """The axes the batch dimension shards over: ('dcn', 'dp') on a
    hybrid mesh, 'dp' otherwise."""
    axes = tuple(a for a in ("dcn", "dp") if a in mesh.axis_names)
    return axes if len(axes) > 1 else axes[0]


def batch_sharding(mesh: Mesh, leading_unsharded: int = 0) -> NamedSharding:
    """Shard a batch along 'dp' (and 'dcn' when present).
    `leading_unsharded` skips leading axes (e.g. the gradient-
    accumulation axis)."""
    spec = P(*([None] * leading_unsharded + [_batch_axes(mesh)]))
    return NamedSharding(mesh, spec)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch, leading_unsharded: int = 0):
    """Place a host batch onto the mesh, batch axis sharded.

    Single-process: a plain device_put (the host holds the global
    batch). Multi-controller: each process loads only its slice of the
    global batch (Trainer._fetch_batch slices each micro-batch to this
    process's contiguous row block) and the global array is assembled
    from the process-local shards."""
    sharding = batch_sharding(mesh, leading_unsharded)
    if jax.process_count() > 1:
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(sharding, x),
            batch,
        )
    return jax.tree.map(lambda x: jax.device_put(x, sharding), batch)


def replicate(mesh: Mesh, tree):
    sharding = replicated_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
