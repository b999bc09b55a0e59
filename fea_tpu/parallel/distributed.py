"""Multi-host (multi-process) runtime entry path.

The reference runs multi-node through HF Accelerate: ``accelerate
launch`` spawns one process per GPU, DDP all-reduces gradients over
NCCL, and every host-side effect — tqdm, checkpoint writes, sampling,
wandb — is gated on ``accelerator.is_main_process`` (reference
model/diffusion.py:456-458, 567-586, 613, 1000).

The JAX equivalent is the multi-controller runtime: one process per
host, ``jax.distributed.initialize`` to form the cluster, a
('dcn', 'dp') device mesh whose outer axis spans processes
(`make_mesh(dcn_size=...)`, parallel/mesh.py), and XLA inserting the
cross-host collectives (NCCL on GPUs) for the dp-sharded batch axis.
All cards of one host are driven by one process over a ('dp',) mesh.

The path is exercised by unit tests with a mocked process count
(tests/test_distributed.py), by a real two-process CPU run
(benchmarks/multiprocess_smoke.py) and by the single-process no-op
branch every CLI run takes. On a cluster, set the FEA_TPU_* variables
below (or a SLURM / COORDINATOR_ADDRESS environment) and every CLI entry
point picks it up via ``ensure_initialized()``.
"""

import os
from typing import Optional

import jax

_INITIALIZED = False
_MULTI = False


def ensure_initialized(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Idempotently join the JAX multi-controller cluster.

    Resolution order: explicit args > ``FEA_TPU_COORDINATOR`` /
    ``FEA_TPU_NUM_PROCESSES`` / ``FEA_TPU_PROCESS_ID`` env >
    ``jax.distributed.initialize()`` auto-detection when a cluster env
    (SLURM, COORDINATOR_ADDRESS) is present. Single-process runs take
    the no-op branch.

    Returns True if a multi-process runtime is (now) active.

    NOTE: on a real cluster this must run BEFORE anything touches the
    backend (jax.devices() & co) — the CLI calls it first thing. The
    single-process branch deliberately does NOT query the backend
    either (host-only CLI commands must not block on device init).
    """
    global _INITIALIZED, _MULTI
    if _INITIALIZED:
        return _MULTI

    coordinator_address = coordinator_address or os.environ.get(
        "FEA_TPU_COORDINATOR"
    )
    if num_processes is None and "FEA_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FEA_TPU_NUM_PROCESSES"])
    if process_id is None and "FEA_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FEA_TPU_PROCESS_ID"])

    auto_env = any(
        k in os.environ for k in ("COORDINATOR_ADDRESS", "SLURM_JOB_ID")
    )
    if coordinator_address is None and not auto_env:
        _INITIALIZED = True  # single process: nothing to join, sticky
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
    _MULTI = jax.process_count() > 1
    return _MULTI


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def is_main_process() -> bool:
    """Reference parity: ``accelerator.is_main_process``
    (diffusion.py:613) — gates checkpoint zips, sample/image writes,
    log files, wandb, and tqdm to exactly one host."""
    return jax.process_index() == 0


def sync_processes(name: str = "fea_tpu_barrier") -> None:
    """Cross-host barrier (the reference's
    ``accelerator.wait_for_everyone()``, diffusion.py:567). No-op on a
    single process."""
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
