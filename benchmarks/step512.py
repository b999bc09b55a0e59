"""512px train-step throughput — the large-image data point: at 512px
the FDN-UNet's innermost full-attention stage runs 4096 tokens (vs 1024
at the flagship 256px). Measures the real jitted train step (f32 and
bf16 compute) on an in-memory dataset; reports steps/s, step FLOPs (XLA
cost analysis), and MFU vs the card's bf16 peak (bench.DEVICE_PEAKS).

The reference trains at 256px (train_model.py:16-71 default) but its
datagen ships 512px images (generate_data_GT.sh) — 512px training is the
capability headroom case, not the flagship config.

Usage: python benchmarks/step512.py [batch] [timed_steps] [--bf16-only] [--remat]
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import device_peaks
from fea_tpu.utils.device import enable_compilation_cache

enable_compilation_cache()
import jax

from fea_tpu.data.arrays import InMemoryFEADataset
from fea_tpu.train.trainer import Trainer, TrainerConfig

batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4
n_timed = int(sys.argv[2]) if len(sys.argv) > 2 else 30

ds = InMemoryFEADataset.generate(
    num_plates=2, conditions_per_plate=4, num_steps=6,
    image_size=512, mesh_size=2e-2, seed=11,
)

peak = device_peaks(jax.devices()[0].device_kind)[0]
out = {"image_size": 512, "batch": batch, "remat": "--remat" in sys.argv}
dtypes = ("bfloat16",) if "--bf16-only" in sys.argv else (None, "bfloat16")
remat = "--remat" in sys.argv
for dtype in dtypes:
    cfg = TrainerConfig(
        dataset_image_size=512,
        train_batch_size=batch,
        # the trainer requires effective batch >= 16 (reference config);
        # at 512px, as micro-batches + accumulation
        num_gradient_accumulation_steps=max(1, -(-16 // batch)),
        remat_loss=remat,
        num_train_steps=1,
        num_steps_per_condition=6,
        num_steps_per_sample_condition=6,
        skip_dataset_size_check=True,
        results_folder=os.path.join(tempfile.gettempdir(), "bench_train512"),
        progress_bar=False,
        compute_dtype=dtype,
    )
    t = Trainer(cfg, dataset=ds, sample_dataset=ds)
    b = t._fetch_batch(0)
    state = t.state
    flops = None
    try:
        cost = t._train_step.lower(state, b).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        flops = float(cost["flops"])
    except Exception as e:  # cost analysis is auxiliary
        print(f"cost_analysis failed: {e}", file=sys.stderr)
    state, _ = t._train_step(state, b)  # compile + warm
    jax.block_until_ready(state.params)
    t0 = time.time()
    for _ in range(n_timed):
        state, _ = t._train_step(state, b)
    jax.block_until_ready(state.params)
    rate = n_timed / (time.time() - t0)
    key = "f32" if dtype is None else dtype
    out[f"steps_per_s_{key}"] = round(rate, 3)
    if flops:
        out[f"step_tflop_{key}"] = round(flops / 1e12, 2)
        # the bf16 peak is the common denominator of both MFUs
        out[f"mfu_{key}"] = round(flops * rate / peak, 4)
    print(f"[{key}] {rate:.3f} steps/s", file=sys.stderr, flush=True)

print(out)
