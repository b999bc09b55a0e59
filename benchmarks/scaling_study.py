"""Unified multi-device scaling evidence on a virtual CPU mesh.

One methodology for every multi-chip number this repo quotes — the
weak-scaling efficiency of parallel/scaling.py (shape-identical
per-device work, >= 1 s per timed measurement, placement asserted) —
applied to all three surfaces:

  datagen-kernel   sharded plate-group solve (shard_map flat body)
  train-step       jitted DP train step (psum-reduced grads)
  datagen-e2e      generate_data_batched --num_devices 8 at the
                   production config (512px, 4 conds x 6 steps,
                   mesh 1e-2): minutes of real end-to-end work on the
                   virtual mesh, reported as plates/hour alongside the
                   same run unsharded.

On the virtual n-device CPU mesh all devices timeshare the host cores,
so wall-clock ratios expose sharding overhead, not speedup; real-chip
projection = n_devices x efficiency (the programs have no cross-device
collectives in datagen and one gradient psum in train). Run on an
otherwise idle host: other processes pollute the timings.

Usage:
  python benchmarks/scaling_study.py [--quick] [--out FILE]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

N_DEV = 8
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={N_DEV}"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")


def e2e_datagen(n_devices, plates, quick):
    """End-to-end generate_data_batched at production config, sharded
    over the virtual mesh vs unsharded — same plates, same seed."""
    from fea_tpu.datagen.batched import generate_data_batched

    cfg = dict(
        image_size=128 if quick else 512,
        conditions_per_plate=4,
        num_steps_per_condition=6,
        mesh_size=0.04 if quick else 1e-2,
        seed=1234,
        batch_size=8,
        verbose=False,
    )
    out = {}
    for label, nd in (("unsharded", 1), (f"{n_devices}dev", n_devices)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            stats = generate_data_batched(
                data_dir=tmp, num_plates=plates, n_devices=nd, **cfg
            )
            wall = time.time() - t0
        out[label] = {
            "wall_s": round(wall, 1),
            "plates": stats["plates"],
            "solves": stats["solves"],
            "cg_failures": stats.get("cg_failures", stats.get("failures")),
            "plates_per_hour": round(3600.0 * stats["plates"] / wall, 1),
        }
    out["config"] = {k: v for k, v in cfg.items() if k != "verbose"}
    return out


def main():
    quick = "--quick" in sys.argv
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]

    from fea_tpu.parallel.scaling import (
        measure_sharding_efficiency,
        measure_train_sharding_efficiency,
    )

    result = {"n_devices": N_DEV, "methodology": (
        "weak scaling, shape-identical per-device work, >=1s per timed "
        "measurement, placement asserted; efficiency = n*t_1dev/t_ndev "
        "on the virtual CPU mesh where devices timeshare the host core"
    )}

    print("datagen-kernel weak scaling...", file=sys.stderr)
    result["datagen_kernel"] = measure_sharding_efficiency(
        N_DEV, mesh_size=0.1 if quick else 0.05,
        min_work_s=0.3 if quick else 1.5,
    )

    print("train-step weak scaling...", file=sys.stderr)
    result["train_step"] = measure_train_sharding_efficiency(
        N_DEV, image_size=16 if quick else 32,
    )

    print("end-to-end sharded datagen (minutes)...", file=sys.stderr)
    result["datagen_e2e"] = e2e_datagen(
        N_DEV, plates=8 if quick else 16, quick=quick
    )

    js = json.dumps(result, indent=2)
    print(js)
    if out_path:
        with open(out_path, "w") as f:
            f.write(js + "\n")


if __name__ == "__main__":
    main()
