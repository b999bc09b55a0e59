"""Benchmark: datagen throughput on the production config, plus per-solve
latency and cantilever displacement-parity — the BASELINE.json metrics.

Scores the BATCHED path (generate_data_batched — chunked plate groups,
double-buffered dispatch, deferred retries), which is the architecture's
real throughput path; the sequential generate_data loop exists for
parity/debug. Prints exactly ONE JSON line to stdout; the per-stage
timing breakdown and diagnostics go to stderr.

Baseline: the reference prints per-condition TIME only (no recorded
numbers); its sfepy/SuperLU datagen runs ~10-60 s per plate on CPU at the
production config (SURVEY.md §6), so vs_baseline uses the 30 s/plate
midpoint -> 120 plates/hour.
"""

import json
import os
import sys
import tempfile
import time

REFERENCE_PLATES_PER_HOUR = 120.0  # 30 s/plate sfepy-CPU estimate (see above)

WARMUP_PLATES = 4
TIMED_PLATES = 16

# Peaks of one card by jax device_kind: (dense bf16 FLOP/s, device-memory
# bytes/s). Source: NVIDIA H100 data sheet (SXM: 989 TFLOP/s bf16 without
# sparsity, 3.35 TB/s HBM3; PCIe: 756 TFLOP/s, 2.0 TB/s), at the card's
# full power limit. The one peak table of the repo: benchmarks/ import it.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
}


def device_peaks(kind: str):
    """(bf16 FLOP/s, bytes/s) of a card; a card missing from the table is
    an error, not a default."""
    if kind not in DEVICE_PEAKS:
        raise KeyError(
            f"no peaks for device kind {kind!r}; add it to DEVICE_PEAKS "
            "with its source"
        )
    return DEVICE_PEAKS[kind]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from fea_tpu.utils.device import enable_compilation_cache

    enable_compilation_cache()

    import jax

    log(f"devices: {jax.devices()}")
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {device.platform}")
    peak = device_peaks(device.device_kind)[0]

    from fea_tpu.datagen.batched import generate_data_batched
    from fea_tpu.utils.profiling import StageTimer

    common = dict(
        image_size=512,
        conditions_per_plate=4,
        mesh_size=1e-2,
        num_steps_per_condition=6,
        save_displacement=True,
        save_meshes=False,
        verbose=False,
    )

    with tempfile.TemporaryDirectory() as tmp:
        log("warmup (populates compile cache)...")
        t0 = time.time()
        generate_data_batched(
            data_dir=os.path.join(tmp, "warm"),
            num_plates=WARMUP_PLATES,
            seed=7,
            **common,
        )
        log(f"warmup {time.time() - t0:.1f}s")

        log(f"timing {TIMED_PLATES} plates (batched path)...")
        stages = StageTimer()
        t0 = time.time()
        stats = generate_data_batched(
            data_dir=os.path.join(tmp, "timed"),
            num_plates=TIMED_PLATES,
            seed=1234,
            stage_timer=stages,
            **common,
        )
        wall = time.time() - t0
        log(f"timed run: {wall:.1f}s")

    plates_per_hour = TIMED_PLATES / wall * 3600.0
    # Device-honest accounting: `solves` counts unique condition attempts
    # DISPATCHED to the device (host-side structural rejections are
    # `host_rejections` and never touch it); `device_busy_s` is the union
    # of in-flight intervals, so busy-time per successful condition is the
    # real device occupancy, not wall divided by a deflated count.
    ok_solves = stats["solves"] - stats["failures"]
    solve_ms = stats["total_solve_time"] / max(ok_solves, 1) * 1000.0
    device_busy_ms = (
        stats.get("device_busy_s", 0.0) / max(ok_solves, 1) * 1000.0
    )

    log("--- per-stage breakdown ---")
    log(stages.summary())
    log(
        f"dispatched solves={stats['solves']} cg_failures={stats['failures']} "
        f"({stats['failures'] / max(stats['solves'], 1):.1%} device failure rate); "
        f"direct_fallbacks={stats.get('direct_fallbacks', 0)} "
        f"cg_resamples={stats.get('cg_resamples', 0)} "
        f"({stats.get('cg_resamples', 0) / max(stats['solves'], 1):.1%} resampled vs reference); "
        f"host_rejections={stats.get('host_rejections', 0)} "
        f"continuations={stats.get('continuations', 0)}"
    )

    # Cantilever golden parity on this hardware (f32 solve + refinement vs
    # the reference's checked-in sfepy solution).
    parity_mae = None
    try:
        import numpy as np

        from fea_tpu.datagen.pipeline import next_bucket
        from fea_tpu.fem import StaticProblem
        from fea_tpu.mesh import read_medit_mesh, read_vtk

        cdir = "/root/reference/applications/cantilever"
        if os.path.isdir(cdir):
            coords, tris = read_medit_mesh(f"{cdir}/cantilever.mesh")
            gt = read_vtk(f"{cdir}/cantilever.vtk")["u"][:, :2]
            cand = coords[:, 0] < 0.01
            edges = set()
            for t in tris:
                for e in range(3):
                    a, b = int(t[e]), int(t[(e + 1) % 3])
                    edges.add((min(a, b), max(a, b)))
            fixed = np.zeros(len(coords), bool)
            for a, b in edges:
                if cand[a] and cand[b]:
                    fixed[a] = fixed[b] = True
            loads = np.zeros((len(coords), 2))
            loads[3] = (0.0, -1000.0)
            from fea_tpu.fem.problem import solve_refined

            problem = StaticProblem(
                coords=coords,
                triangles=tris,
                young=np.full(len(tris), 210000.0),
                poisson=np.full(len(tris), 0.3),
                fixed_nodes=fixed,
                loads=loads,
                num_steps=2,
            )
            res = solve_refined(
                problem,
                pad_buckets=(
                    next_bucket(len(coords) + 3),
                    next_bucket(len(tris)),
                ),
            )
            u = np.asarray(res.displacements[-1])
            parity_mae = float(np.abs(u - gt).mean() / np.abs(gt).max())
    except Exception as e:  # parity is auxiliary; never sink the bench
        log(f"parity check failed: {e}")

    # Training-step throughput at the flagship config (256px, batch 16) —
    # the second half of the system (reference train_model.py:41-59). A
    # tiny in-memory dataset feeds the real jitted train step; timing
    # excludes compile (first step) and blocks on the final state.
    train_steps_per_s = None
    train_steps_per_s_bf16 = None
    train_steps_per_s_accum = None
    train_flops = None
    train_mfu = None
    train_mfu_bf16 = None
    train_mfu_accum = None
    try:
        import jax

        from fea_tpu.data.arrays import InMemoryFEADataset
        from fea_tpu.train.trainer import Trainer, TrainerConfig

        log("train-step bench (256px, batch 16)...")
        ds = InMemoryFEADataset.generate(
            num_plates=2, conditions_per_plate=4, num_steps=6,
            image_size=256, mesh_size=2e-2, seed=11,
        )
        cfg = TrainerConfig(
            dataset_image_size=256,
            train_batch_size=16,
            num_train_steps=1,
            num_steps_per_condition=6,
            num_steps_per_sample_condition=6,
            skip_dataset_size_check=True,
            results_folder=os.path.join(tempfile.gettempdir(), "bench_train"),
            progress_bar=False,
        )
        trainer = Trainer(cfg, dataset=ds, sample_dataset=ds)
        batch = trainer._fetch_batch(0)
        state = trainer.state
        # XLA's own FLOP count for the compiled step (before the timing
        # run so a cost-analysis failure can't poison the measurement)
        train_flops = None
        try:
            cost = (
                trainer._train_step.lower(state, batch).compile().cost_analysis()
            )
            if isinstance(cost, (list, tuple)):
                cost = cost[0]
            train_flops = float(cost["flops"])
        except Exception as e:
            log(f"cost analysis unavailable: {e}")
        state, _ = trainer._train_step(state, batch)  # compile + warm
        jax.block_until_ready(state.params)
        n_timed = 10
        t0 = time.time()
        for _ in range(n_timed):
            state, _ = trainer._train_step(state, batch)
        jax.block_until_ready(state.params)
        train_steps_per_s = n_timed / (time.time() - t0)
        log(f"train steps/s: {train_steps_per_s:.3f}")

        # bf16 mixed-precision variant (compute_dtype: bf16 compute,
        # f32 master weights)
        try:
            cfg16 = TrainerConfig(**{
                **cfg.__dict__, "compute_dtype": "bfloat16",
                "results_folder": cfg.results_folder + "_bf16",
            })
            tr16 = Trainer(cfg16, dataset=ds, sample_dataset=ds)
            b16 = tr16._fetch_batch(0)
            s16 = tr16.state
            s16, _ = tr16._train_step(s16, b16)
            jax.block_until_ready(s16.params)
            t0 = time.time()
            for _ in range(n_timed):
                s16, _ = tr16._train_step(s16, b16)
            jax.block_until_ready(s16.params)
            train_steps_per_s_bf16 = n_timed / (time.time() - t0)
            log(f"train steps/s (bf16 compute): {train_steps_per_s_bf16:.3f}")
        except Exception as e:
            log(f"bf16 train bench failed: {e}")
            train_steps_per_s_bf16 = None

        # Accumulation rung (b8 x accum2 = effective 16, bf16): same
        # effective batch and loss/optimizer math as the single-pass
        # step, so the useful FLOPs per step are train_flops; only the
        # schedule differs.
        try:
            cfga = TrainerConfig(**{
                **cfg.__dict__,
                "compute_dtype": "bfloat16",
                "train_batch_size": 8,
                "num_gradient_accumulation_steps": 2,
                "results_folder": cfg.results_folder + "_accum",
            })
            tra = Trainer(cfga, dataset=ds, sample_dataset=ds)
            ba = tra._fetch_batch(0)
            sa = tra.state
            sa, _ = tra._train_step(sa, ba)
            jax.block_until_ready(sa.params)
            t0 = time.time()
            for _ in range(n_timed):
                sa, _ = tra._train_step(sa, ba)
            jax.block_until_ready(sa.params)
            train_steps_per_s_accum = n_timed / (time.time() - t0)
            log(
                "train steps/s (bf16, b8 x accum2 production step): "
                f"{train_steps_per_s_accum:.3f}"
            )
        except Exception as e:
            log(f"accum train bench failed: {e}")

        if train_flops:
            kind = device.device_kind
            train_mfu = train_flops * train_steps_per_s / peak
            log(
                f"train step {train_flops / 1e12:.2f} TFLOP -> "
                f"MFU {train_mfu:.1%} of {kind} bf16 peak (f32 step)"
            )
            if train_steps_per_s_bf16:
                train_mfu_bf16 = (
                    train_flops * train_steps_per_s_bf16 / peak
                )
                log(
                    f"bf16 production step -> MFU "
                    f"{train_mfu_bf16:.1%} of {kind} bf16 peak"
                )
            if train_steps_per_s_accum:
                train_mfu_accum = (
                    train_flops * train_steps_per_s_accum / peak
                )
                log(
                    f"bf16 accum production step -> MFU "
                    f"{train_mfu_accum:.1%} of {kind} bf16 peak"
                )
    except Exception as e:  # auxiliary metric; never sink the bench
        log(f"train-step bench failed: {e}")

    # Placement efficiency of the dp-sharded solve, measured on a
    # virtual CPU mesh in a subprocess (parallel/scaling.py) — not an
    # accelerator number. FEA_TPU_BENCH_SCALING=<n>|0 to override/disable.
    scaling = None
    n_scale = int(os.environ.get("FEA_TPU_BENCH_SCALING", "8"))
    if n_scale > 1:
        try:
            import subprocess

            code = (
                "import os, json, jax\n"
                "jax.config.update('jax_platforms', 'cpu')\n"
                "from fea_tpu.parallel.scaling import "
                "measure_sharding_efficiency\n"
                f"print(json.dumps(measure_sharding_efficiency({n_scale})))\n"
            )
            env = dict(
                os.environ,
                JAX_PLATFORMS="cpu",
                XLA_FLAGS=(
                    os.environ.get("XLA_FLAGS", "")
                    + f" --xla_force_host_platform_device_count={n_scale}"
                ).strip(),
            )
            out = subprocess.run(
                [sys.executable, "-c", code],
                capture_output=True, text=True, timeout=600, env=env,
            )
            scaling = json.loads(out.stdout.strip().splitlines()[-1])
            log(
                f"sharding efficiency ({n_scale} virtual devices): "
                f"{scaling.get('efficiency')}"
            )
        except Exception as e:
            log(f"scaling bench failed: {e}")

    # Structural-screen validation vs the reference's solver: a fresh
    # small sample scored against a SuperLU f64 oracle in a CPU
    # subprocess. 'false rejects' = conditions the screen drops that
    # the reference's NaN check would have kept; at the bounded bar
    # (|u| <= 1e6) this should be ~0 — see benchmarks/screen_oracle.py
    # and docs/screen_oracle.json for the full 500-condition study.
    # n=128: at n=32 a 3x regression in bounded false-rejects is
    # indistinguishable from zero; 128 draws
    # put ~1.3 expected bounded false-rejects in the sample at the
    # studied 1.33% rate, so a 3x regression reads ~4 events.
    screen = None
    n_oracle = int(os.environ.get("FEA_TPU_BENCH_ORACLE", "128"))
    if n_oracle > 0:
        try:
            import subprocess

            out = subprocess.run(
                [
                    sys.executable,
                    os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "screen_oracle.py",
                    ),
                    "--quick", "--n", str(n_oracle),
                ],
                capture_output=True, text=True, timeout=900,
                env=dict(os.environ, JAX_PLATFORMS="cpu"),
            )
            screen = json.loads(out.stdout.strip().splitlines()[-1])
            log(
                f"screen oracle (n={n_oracle}): false-reject rate "
                f"{screen.get('screen_false_reject_rate')} "
                f"(bounded {screen.get('screen_false_reject_rate_bounded')})"
            )
        except Exception as e:
            log(f"screen-oracle bench failed: {e}")

    result = {
        "metric": "datagen_plates_per_hour",
        "value": round(plates_per_hour, 2),
        "unit": "plates/hour (512px, 4 conds x 6 steps, mesh 1e-2, batched)",
        "vs_baseline": round(plates_per_hour / REFERENCE_PLATES_PER_HOUR, 2),
        "timed_wall_s": round(wall, 1),
        "solve_wall_ms_per_condition_upper_bound": round(solve_ms, 2),
        "device_busy_ms_per_condition": round(device_busy_ms, 2),
        "device_busy_s": round(stats.get("device_busy_s", 0.0), 2),
        "relative_parity_mae_cantilever": parity_mae,
        "dispatched_solves": stats["solves"],
        "cg_failures": stats.get("cg_failures"),
        "direct_fallbacks": stats.get("direct_fallbacks"),
        "cg_resamples": stats.get("cg_resamples"),
        "host_rejections": stats.get("host_rejections"),
        "continuations": stats.get("continuations"),
        "lane_dispatches": stats.get("lane_dispatches"),
        "train_steps_per_s_256px_b16": (
            round(train_steps_per_s, 3) if train_steps_per_s else None
        ),
        "train_steps_per_s_256px_b16_bf16": (
            round(train_steps_per_s_bf16, 3) if train_steps_per_s_bf16 else None
        ),
        "train_step_tflop": (
            round(train_flops / 1e12, 2) if train_flops else None
        ),
        "device_kind": device.device_kind,
        # f32-step MFU against the bf16 peak; the bf16 field is the
        # production configuration
        "train_mfu_vs_bf16_peak": (
            round(train_mfu, 4) if train_mfu else None
        ),
        "train_mfu_bf16_step_vs_bf16_peak": (
            round(train_mfu_bf16, 4) if train_mfu_bf16 else None
        ),
        "train_steps_per_s_accum_b8x2_bf16": (
            round(train_steps_per_s_accum, 3)
            if train_steps_per_s_accum else None
        ),
        "train_mfu_accum_step_vs_bf16_peak": (
            round(train_mfu_accum, 4) if train_mfu_accum else None
        ),
        "stage_seconds": {
            k: round(v, 2) for k, v in sorted(stages.as_dict().items())
        },
        "sharding_efficiency_virtual_mesh": scaling,
        "screen_false_reject_rate": (
            screen.get("screen_false_reject_rate") if screen else None
        ),
        "screen_false_reject_rate_bounded": (
            screen.get("screen_false_reject_rate_bounded")
            if screen else None
        ),
        "screen_oracle_sample": (
            screen.get("n_conditions") if screen else None
        ),
        "baseline_note": "reference sfepy-CPU est. 120 plates/hour (30s/plate)",
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
