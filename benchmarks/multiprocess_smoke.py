"""REAL 2-process jax.distributed run of the multi-host training path.

tests/test_distributed.py checks `parallel/distributed.py` and the
('dcn','dp') mesh under mocks. This script executes the actual runtime
path — the JAX equivalent of the reference's multi-node Accelerate
launch (reference model/diffusion.py:456-586) — with two genuine OS
processes on the CPU backend (gloo collectives), localhost coordinator:

  * `parallel.distributed.ensure_initialized` joins the cluster from
    the FEA_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID env (the exact
    resolution path a real deployment uses),
  * `parallel.mesh.make_mesh()` auto-builds the ('dcn','dp') mesh over
    2 processes x 2 local devices, grouped by process (the real
    multi-host branch),
  * the real Trainer runs `_fetch_batch` (per-process local batch
    slice -> jax.make_array_from_process_local_data assembly) and ONE
    dp-sharded train step whose gradient psum crosses the process
    boundary over gloo,
  * `save_checkpoint` executes the sync_processes barrier +
    process-0-only write; the launcher asserts exactly one process
    wrote it,
  * both processes must agree bitwise on the loss (replicated step).

Usage:
  timeout 1800 python benchmarks/multiprocess_smoke.py          # launcher
  (workers are spawned internally with --worker N)

This smoke proves the runtime wiring, not interconnect performance.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = 29881
RESULTS = "/tmp/fea_tpu_mp_smoke"


def worker(pid: int) -> None:
    import faulthandler

    # periodic all-thread stack dumps: the only hang diagnostic on this
    # box (no py-spy/gdb); the launcher prints worker output on failure
    faulthandler.dump_traceback_later(240, repeat=True)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from fea_tpu.parallel.distributed import (
        ensure_initialized,
        is_main_process,
        process_count,
    )

    def mark(msg: str) -> None:
        print(f"[w{pid} +{time.time():.0f}] {msg}", flush=True)

    mark("init")
    multi = ensure_initialized()  # from FEA_TPU_* env, like a real deploy
    assert multi, "expected a multi-process runtime"
    assert process_count() == 2
    assert jax.local_device_count() == 2
    assert jax.device_count() == 4

    from fea_tpu.data.arrays import InMemoryFEADataset
    from fea_tpu.parallel.distributed import sync_processes
    from fea_tpu.parallel.mesh import make_mesh
    from fea_tpu.train.trainer import Trainer, TrainerConfig

    mesh = make_mesh()  # auto: hybrid ('dcn', 'dp') = (2, 2)
    assert mesh.axis_names == ("dcn", "dp"), mesh.axis_names
    assert mesh.devices.shape == (2, 2), mesh.devices.shape

    # Establish the gloo context NOW, while inter-process skew is
    # seconds: gloo's context-init rendezvous times out at 30 s, and on
    # a timeshared 1-core host the train-step compile can skew the
    # processes by minutes (measured: the first run of this smoke died
    # exactly there).
    mark("pre-warmup-sync")
    sync_processes("mp_smoke_gloo_warmup")
    mark("warmup-sync done")

    # same seed -> identical data in both processes (each host of a real
    # deployment sees the same store; _fetch_batch slices its local rows)
    ds = InMemoryFEADataset.generate(
        num_plates=1,
        conditions_per_plate=2,
        num_steps=3,
        image_size=32,
        mesh_size=0.08,
        seed=9,
        holes_per_polygon_range=(0, 0),
    )
    cfg = TrainerConfig(
        dataset_folder="unused",
        sample_dataset_folder="unused",
        dataset_image_size=32,
        train_batch_size=8,
        num_gradient_accumulation_steps=2,
        num_train_steps=1,
        num_steps_per_condition=3,
        num_steps_per_sample_condition=3,
        conditions_per_plate=2,
        results_folder=RESULTS,
        skip_dataset_size_check=True,
        input_dim=16,
        progress_bar=False,
    )
    mark("dataset done; building Trainer")
    t = Trainer(cfg, dataset=ds, sample_dataset=ds)
    mark("Trainer built")
    batch = t._fetch_batch(0)  # local slice + process-local assembly
    for v in batch.values():
        # global batch axis: every process sees the GLOBAL shape but
        # holds only its local shard rows
        assert v.shape[1] == cfg.train_batch_size, v.shape
    # AOT-compile the step (local work), then align the processes on
    # the coordination-service barrier (KV store, long timeout) so the
    # gloo gradient-psum never has to wait across compile skew — gloo
    # ops time out at 30 s; XLA:CPU compiles this step in minutes.
    mark("batch fetched; AOT compile")
    compiled_step = t._train_step.lower(t.state, batch).compile()
    mark("compiled")
    from jax._src import distributed as _jdist

    _jdist.global_state.client.wait_at_barrier(
        "mp_smoke_compiled", 1_200_000
    )
    mark("compile barrier passed; running step")
    state, loss = compiled_step(t.state, batch)
    jax.block_until_ready(state.params)
    t.state = state
    mark("step done; saving checkpoint")
    t.save_checkpoint("mp-smoke")  # barrier + process-0-only write
    mark("checkpoint saved")
    # align exits: save_checkpoint's barrier precedes the write, so the
    # non-main process would otherwise exit minutes before process 0
    # finishes the checkpoint write on a busy host and jax's
    # shutdown barrier would expire (observed: DEADLINE_EXCEEDED at
    # Shutdown::).
    _jdist.global_state.client.wait_at_barrier("mp_smoke_done", 1_200_000)
    print(
        json.dumps(
            {
                "process": pid,
                "is_main": is_main_process(),
                "loss": float(loss),
                "mesh": str(mesh.shape),
            }
        ),
        flush=True,
    )


def launcher() -> None:
    if os.path.exists(RESULTS):
        import shutil

        shutil.rmtree(RESULTS)
    env_base = dict(
        os.environ,
        XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=2"
        ).strip(),
        FEA_TPU_COORDINATOR=f"localhost:{PORT}",
        FEA_TPU_NUM_PROCESSES="2",
    )
    t0 = time.time()
    deadline_s = int(os.environ.get("MP_SMOKE_DEADLINE_S", "1500"))
    logs = [open(f"/tmp/mp_smoke_worker{i}.log", "w+") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
            env=dict(env_base, FEA_TPU_PROCESS_ID=str(i)),
            stdout=logs[i],
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    # hang watchdog: a wedged gloo collective futex-waits forever with no
    # timeout; on deadline kill BOTH workers by exact pid and print both
    # logs (the workers' faulthandler dumps locate the hang)
    while time.time() - t0 < deadline_s:
        if all(p.poll() is not None for p in procs):
            break
        time.sleep(5)
    timed_out = any(p.poll() is None for p in procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    rcs = [p.returncode for p in procs]
    reports = []
    for i, (rc, out) in enumerate(zip(rcs, outs)):
        if timed_out or rc != 0:
            print(f"===== worker {i} (rc={rc}) =====")
            print(out[-8000:])
    if timed_out:
        raise SystemExit(f"workers hung past {deadline_s}s deadline")
    for i, (rc, out) in enumerate(zip(rcs, outs)):
        if rc != 0:
            raise SystemExit(f"worker {i} failed rc={rc}")
        last = [l for l in out.splitlines() if l.startswith("{")][-1]
        reports.append(json.loads(last))

    # exactly one main process; bitwise-identical replicated loss
    assert sorted(r["is_main"] for r in reports) == [False, True], reports
    assert reports[0]["loss"] == reports[1]["loss"], reports
    assert all(r["mesh"] == reports[0]["mesh"] for r in reports)
    ckpt = os.path.join(RESULTS, "model-mp-smoke")
    assert os.path.isdir(ckpt), "process-0 checkpoint missing"
    print(
        json.dumps(
            {
                "ok": True,
                "wall_s": round(time.time() - t0, 1),
                "processes": 2,
                "global_devices": 4,
                "mesh": reports[0]["mesh"],
                "loss": reports[0]["loss"],
                "checkpoint": ckpt,
            }
        )
    )


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
    else:
        launcher()
