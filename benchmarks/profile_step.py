"""Per-component breakdown + roofline of the flagship train step.

Attribution is by ABLATION: each pipeline prefix is jitted and timed
separately on the card —

    enc        encoder forward
    enc+aux    + auxiliary heads
    fwd        + decoder + masking + loss (full forward)
    grad       value_and_grad of the loss (forward + backward)
    step       the production train step (grad + 3 Adam chains +
               clip-by-global-norm + EMA + non-finite guard)

and each component gets XLA cost analysis (FLOPs, bytes accessed) from
its compiled executable, so the table shows achieved TFLOP/s vs the
card's bf16 peak and achieved GB/s vs its memory bandwidth
(bench.DEVICE_PEAKS) per component — a component near the bandwidth
roof is memory-bound and no kernel tuning will move it without
fusion/layout changes.

Differences between rows attribute time: grad - fwd ~= backward;
step - grad ~= optimizer/EMA (pure memory traffic over params).

Usage:
  python benchmarks/profile_step.py [image_size] [batch]
       [--dtype bfloat16|float32] [--input_dim N] [--json]

Needs the card to itself: one process per card.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from bench import device_peaks
from fea_tpu.utils.device import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from fea_tpu.data.arrays import InMemoryFEADataset
from fea_tpu.train.trainer import Trainer, TrainerConfig

def main():
    PEAK_FLOPS, PEAK_BYTES = device_peaks(jax.devices()[0].device_kind)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    S = int(args[0]) if len(args) > 0 else 256
    B = int(args[1]) if len(args) > 1 else 16
    dtype = "bfloat16"
    if "--dtype" in sys.argv:
        dtype = sys.argv[sys.argv.index("--dtype") + 1]
    input_dim = 64
    if "--input_dim" in sys.argv:  # reduced width for CPU smokes
        input_dim = int(sys.argv[sys.argv.index("--input_dim") + 1])
    emit_json = "--json" in sys.argv

    ds = InMemoryFEADataset.generate(
        num_plates=2, conditions_per_plate=4, num_steps=6,
        image_size=S, mesh_size=2e-2 if S >= 256 else 0.05, seed=11,
    )
    cfg = TrainerConfig(
        dataset_image_size=S,
        train_batch_size=B,
        # the production trainer requires effective batch >= 16; at B=8
        # this matches the shipped tables+accum rung (b8 x accum2).
        # Ceiling division so non-divisors of 16 still clear the guard.
        num_gradient_accumulation_steps=max(1, -(-16 // B)),
        num_train_steps=1,
        num_steps_per_condition=6,
        num_steps_per_sample_condition=6,
        skip_dataset_size_check=True,
        results_folder=os.path.join(tempfile.gettempdir(), "bench_profile_step"),
        progress_bar=False,
        compute_dtype=None if dtype == "float32" else dtype,
        disable_auxiliary=False,
        use_ema=True,
        input_dim=input_dim,
    )
    t = Trainer(cfg, dataset=ds, sample_dataset=ds)
    batch = t._fetch_batch(0)
    state = t.state
    # strip the accumulation axis for the sub-component functions
    micro = {k: v[0] for k, v in batch.items()}
    micro = t._unpack_transfer(micro)

    dt = jnp.dtype(dtype) if dtype != "float32" else None

    def cast(tree):
        if dt is None:
            return tree
        return jax.tree.map(
            lambda x: x.astype(dt)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            tree,
        )

    conditions = jnp.concatenate(
        [micro["forces"], micro["constraints"]], axis=-1
    )

    def enc(params, materials, conds):
        x, hidden, residual = t.encoder.apply(
            {"params": cast(params["encoder"])}, cast(materials),
            cast(conds),
        )
        return x, hidden, residual

    def enc_aux(params, materials, conds):
        x, hidden, residual = enc(params, materials, conds)
        sign, log = t.auxiliary.apply(
            {"params": cast(params["auxiliary"])}, x
        )
        return x, sign, log

    def fwd(params, mb):
        return t._loss(params, mb)

    grad = jax.value_and_grad(fwd)

    rows = []

    def record(name, best, flops, bytes_):
        rows.append({
            "name": name,
            "ms": round(best * 1e3, 2),
            "tflops": round(flops / 1e12, 3) if flops else None,
            "achieved_tflops_s": (
                round(flops / best / 1e12, 1) if flops else None
            ),
            "flop_util": round(flops / best / PEAK_FLOPS, 3) if flops else None,
            "gb_accessed": round(bytes_ / 1e9, 2) if bytes_ else None,
            "achieved_gb_s": (
                round(bytes_ / best / 1e9, 1) if bytes_ else None
            ),
            "mem_util": (
                round(bytes_ / best / PEAK_BYTES, 3) if bytes_ else None
            ),
        })

    def cost_of(lowerable, *a):
        try:
            cost = lowerable.lower(*a).compile().cost_analysis()
            if isinstance(cost, (list, tuple)):
                cost = cost[0]
            return (
                float(cost.get("flops", 0.0)),
                float(cost.get("bytes accessed", 0.0)),
            )
        except Exception as e:
            print(f"cost_analysis failed: {e}", file=sys.stderr)
            return None, None

    def bench(name, fn, *a, n_timed=20):
        f = jax.jit(fn)
        flops, bytes_ = cost_of(f, *a)
        out = f(*a)  # compile + warm
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            o = None
            for _ in range(n_timed):
                o = f(*a)
            jax.block_until_ready(o)
            best = min(best, (time.perf_counter() - t0) / n_timed)
        record(name, best, flops, bytes_)
        return out

    params = state.params
    bench("enc", enc, params, micro["materials"], conditions)
    bench("enc+aux", enc_aux, params, micro["materials"], conditions)
    bench("fwd(loss)", fwd, params, micro)
    bench("grad", grad, params, micro)

    # the production step donates its state arg: thread it through.
    # XLA's cost_analysis counts the accumulation scan body ONCE; scale
    # by the accum factor so the step row reflects the work actually
    # executed.
    flops, bytes_ = cost_of(t._train_step, state, batch)
    accum = cfg.num_gradient_accumulation_steps
    if accum > 1:
        flops = flops * accum if flops else flops
        bytes_ = bytes_ * accum if bytes_ else bytes_
    st, _ = t._train_step(state, batch)  # compile (donates `state`)
    jax.block_until_ready(st.params)
    n_timed = 10
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_timed):
            st, _l = t._train_step(st, batch)
        jax.block_until_ready(st.params)
        best = min(best, (time.perf_counter() - t0) / n_timed)
    record("step", best, flops, bytes_)

    result = {
        "image_size": S, "batch": B, "dtype": dtype,
        "input_dim": input_dim,
        "accum": cfg.num_gradient_accumulation_steps,
        "rows": rows,
    }
    if emit_json:
        print(json.dumps(result))
    else:
        hdr = (
            f"{'component':<12}{'ms':>9}{'TFLOP':>9}{'TF/s':>8}"
            f"{'FLOP%':>7}{'GB':>8}{'GB/s':>8}{'mem%':>7}"
        )
        print(f"profile_step {S}px b{B} {dtype}")
        print(hdr)
        for r in rows:
            print(
                f"{r['name']:<12}{r['ms']:>9}{r['tflops'] or '-':>9}"
                f"{r['achieved_tflops_s'] or '-':>8}"
                f"{(round(100 * r['flop_util'], 1) if r['flop_util'] else '-'):>7}"
                f"{r['gb_accessed'] or '-':>8}{r['achieved_gb_s'] or '-':>8}"
                f"{(round(100 * r['mem_util'], 1) if r['mem_util'] else '-'):>7}"
            )
        # derived attributions
        by = {r["name"]: r["ms"] for r in rows}
        if "grad" in by and "fwd(loss)" in by:
            print(f"backward ~= {by['grad'] - by['fwd(loss)']:.2f} ms")
        if "step" in by and "grad" in by:
            acc = cfg.num_gradient_accumulation_steps
            print(
                f"optimizer+EMA+guard ~= "
                f"{by['step'] - acc * by['grad']:.2f} ms "
                f"(step runs {acc}x grad via lax.scan)"
            )


if __name__ == "__main__":
    main()
