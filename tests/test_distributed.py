"""Multi-host readiness (parallel/distributed.py + the hybrid mesh).

These tests exercise the multi-host code path the way the reference's
Accelerate integration is tested in CI: the single-process no-op
branch, the cluster-join argument plumbing (mocked
jax.distributed.initialize), the main-process gates (mocked process
index), and the hybrid ('dcn', 'dp') mesh layout on the virtual
8-device CPU mesh. Reference behavior being mirrored:
is_main_process gating of checkpoints/sampling/wandb
(/root/reference/model/diffusion.py:567-586, 613) and multi-node DDP
launch (diffusion.py:456-458).
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import fea_tpu.parallel.distributed as dist
from fea_tpu.parallel.mesh import batch_sharding, make_mesh, shard_batch


@pytest.fixture(autouse=True)
def _reset_dist_state():
    before = (dist._INITIALIZED, dist._MULTI)
    yield
    dist._INITIALIZED, dist._MULTI = before


def test_single_process_noop(monkeypatch):
    """No cluster env -> no jax.distributed.initialize call at all."""
    for k in ("FEA_TPU_COORDINATOR", "FEA_TPU_NUM_PROCESSES",
              "FEA_TPU_PROCESS_ID", "COORDINATOR_ADDRESS", "SLURM_JOB_ID"):
        monkeypatch.delenv(k, raising=False)
    dist._INITIALIZED = False

    def boom(**kw):
        raise AssertionError("initialize must not be called")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    assert dist.ensure_initialized() is False
    # idempotent: the decision is sticky
    assert dist.ensure_initialized() is False


def test_env_cluster_join(monkeypatch):
    """FEA_TPU_* env plumbs through to jax.distributed.initialize."""
    monkeypatch.setenv("FEA_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("FEA_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("FEA_TPU_PROCESS_ID", "2")
    dist._INITIALIZED = False
    calls = {}

    def fake_init(coordinator_address=None, num_processes=None,
                  process_id=None):
        calls.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    dist.ensure_initialized()
    assert calls == {
        "coordinator_address": "10.0.0.1:1234",
        "num_processes": 4,
        "process_id": 2,
    }


def test_is_main_process_gate(monkeypatch):
    monkeypatch.setattr(jax, "process_index", lambda: 3)
    assert dist.is_main_process() is False
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    assert dist.is_main_process() is True


def test_sync_processes_single_process_noop():
    dist.sync_processes("unit")  # must not raise / require a cluster


def test_hybrid_mesh_layout():
    """dcn_size=2 over 8 virtual devices: ('dcn','dp') mesh of shape
    (2,4); the batch axis shards over ALL 8 devices."""
    mesh = make_mesh(8, dcn_size=2)
    assert mesh.axis_names == ("dcn", "dp")
    assert mesh.devices.shape == (2, 4)

    sh = batch_sharding(mesh)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = jax.device_put(x, sh)
    shards = arr.addressable_shards
    assert len(shards) == 8
    assert all(s.data.shape == (1, 3) for s in shards)
    np.testing.assert_array_equal(np.asarray(arr), x)


def test_hybrid_mesh_batch_roundtrip_matches_flat():
    """The ('dcn','dp') batch placement computes the same program
    results as the flat ('dp',) mesh: same global values, same order."""
    flat = make_mesh(8)
    hybrid = make_mesh(8, dcn_size=4)
    batch = {"a": np.arange(16, dtype=np.float32).reshape(8, 2)}
    out_flat = shard_batch(flat, batch)
    out_hybrid = shard_batch(hybrid, batch)
    np.testing.assert_array_equal(
        np.asarray(out_flat["a"]), np.asarray(out_hybrid["a"])
    )


def test_hybrid_mesh_psum_gradient_reduction():
    """A jitted loss over the hybrid mesh reduces across BOTH axes —
    the multi-host DP gradient all-reduce the trainer relies on."""
    mesh = make_mesh(8, dcn_size=2)
    sh = batch_sharding(mesh)
    x = jax.device_put(np.ones((8, 4), np.float32), sh)

    @jax.jit
    def mean_sq(v):
        return (v**2).mean()

    assert float(mean_sq(x)) == pytest.approx(1.0)


def test_make_mesh_rejects_indivisible_dcn():
    with pytest.raises(AssertionError):
        make_mesh(8, dcn_size=3)


def test_save_checkpoint_nonmain_participates_without_writing(
    tmp_path, monkeypatch
):
    """A non-main host still reaches the save barrier — every process
    must, or process 0 waits forever — but writes nothing: no
    checkpoint file, no rotation or deletion, no zip artifact. Reference
    analog: every Accelerate rank enters save() and only the main
    process writes (diffusion.py:567, 613)."""
    import numpy as np

    from fea_tpu.train import trainer as trainer_mod
    from fea_tpu.train.trainer import Trainer

    barriers = []
    monkeypatch.setattr(trainer_mod, "sync_processes", barriers.append)
    (tmp_path / "model-best").mkdir()  # would be deleted by the main host
    fake = SimpleNamespace(
        is_main=False,
        results_folder=tmp_path,
        state={"p": np.zeros((2,), np.float32)},
        _ckpt_dir=lambda m: tmp_path / f"model-{m}",
    )
    Trainer.save_checkpoint(fake, "best")
    assert barriers == ["save_checkpoint_best"]
    assert [p.name for p in tmp_path.iterdir()] == ["model-best"]
    assert list((tmp_path / "model-best").iterdir()) == []

    # the main host, same call: barrier, then checkpoint + zip
    fake.is_main = True
    fake.delete_checkpoint_if_exists = lambda m: Trainer.delete_checkpoint_if_exists(fake, m)
    Trainer.save_checkpoint(fake, "best")
    assert barriers == ["save_checkpoint_best"] * 2
    assert (tmp_path / "model-best" / "checkpoint.npz").is_file()
    assert (tmp_path / "model-best.zip").is_file()


def test_fetch_batch_slices_local_rows(monkeypatch):
    """Under a mocked 2-process runtime, _fetch_batch decodes only the
    contiguous block of rows this process's devices own."""
    from fea_tpu.train import trainer as trainer_mod
    from fea_tpu.train.trainer import Trainer

    seen = []

    class RecordingDataset:
        def __getitem__(self, i):
            seen.append(int(i))
            return {"x": np.zeros((2,), np.float32)}

    captured = {}

    def fake_shard_batch(mesh, batch, leading_unsharded=0):
        captured["batch"] = batch
        return batch

    monkeypatch.setattr(trainer_mod, "shard_batch", fake_shard_batch)
    monkeypatch.setattr(trainer_mod.jax, "process_count", lambda: 2)
    monkeypatch.setattr(trainer_mod.jax, "process_index", lambda: 1)

    fake = SimpleNamespace(
        config=SimpleNamespace(
            train_batch_size=4, num_gradient_accumulation_steps=2
        ),
        sampler=SimpleNamespace(
            indices_at=lambda off, count: np.arange(off, off + count)
        ),
        device_tables=None,
        dataset=RecordingDataset(),
        mesh=None,
        _pack_transfer=lambda b: b,
    )
    Trainer._fetch_batch(fake, 0)
    # global micro-batches are rows [0..3] and [4..7]; process 1 of 2
    # owns the upper half of each: 2,3 and 6,7
    assert seen == [2, 3, 6, 7]
    assert captured["batch"]["x"].shape == (2, 2, 2)
