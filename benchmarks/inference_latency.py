"""Surrogate serving latency/throughput (the reference's headline
"near-instantaneous analysis", reference README.md:10, made
quantitative).

Measures the jitted inference forward (encoder -> decoder -> geometry
masking, exactly apps/runner.py's predict path / the reference's
generateapplication.ipynb cells 8-18) on the card:

  latency_b1_ms       device time per forward at batch 1
  latency_b1_fetch_ms batch-1 wall incl. the device->host image fetch
  throughput_bN       predictions/s at a serving batch

Device times come from chained forwards closed by block_until_ready.
No checkpoint required: serving cost is weight-independent, so random
init measures the same program the production model runs.

Usage:
  python benchmarks/inference_latency.py [--json] [--image_size 256]
      [--batch 16] [--dtype bfloat16] [--input_dim 64]
"""

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from fea_tpu.utils.device import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from fea_tpu.models import create_models


def arg(flag, default, cast):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


def main():
    S = arg("--image_size", 256, int)
    B = arg("--batch", 16, int)
    dtype = arg("--dtype", "bfloat16", str)
    input_dim = arg("--input_dim", 64, int)
    emit_json = "--json" in sys.argv
    dt = jnp.dtype(dtype)

    encoder, decoder, _aux = create_models(
        input_dim=input_dim, image_height=S, image_width=S,
        num_channels=2, num_auxiliary_condition_channels=3,
        num_stages=4,
    )

    rng = jax.random.PRNGKey(0)

    def init_batch(b):
        return (
            jnp.zeros((b, S, S, 2), dt),   # materials
            jnp.zeros((b, S, S, 3), dt),   # forces(2) + constraints(1)
            jnp.zeros((b, S, S, 1), dt),   # geometry
        )

    materials, conditions, geometry = init_batch(1)
    enc_vars = encoder.init(rng, materials, conditions)
    x, hidden, residual = encoder.apply(enc_vars, materials, conditions)
    dec_vars = decoder.init(rng, x, list(hidden), residual)

    params = {
        "encoder": jax.tree.map(lambda a: a.astype(dt), enc_vars["params"]),
        "decoder": jax.tree.map(lambda a: a.astype(dt), dec_vars["params"]),
    }

    @jax.jit
    def predict(params, materials, conditions, geometry):
        # apps/runner.py:319-326 — forward + the reference's geometry
        # remasking of the signed output
        x, hidden, residual = encoder.apply(
            {"params": params["encoder"]}, materials, conditions
        )
        image = decoder.apply(
            {"params": params["decoder"]}, x, list(hidden), residual
        )
        return ((image + 1.0) / 2.0 * (geometry + 1.0) / 2.0) * 2.0 - 1.0

    def bench_batch(b, n_timed=50):
        """Time n_timed CHAINED forwards, closed by block_until_ready.
        The forwards are chained through a data dependency (the
        predicted image IS materials-shaped) so XLA cannot elide any."""
        batch = init_batch(b)

        @jax.jit
        def chain(params, materials, conditions, geometry):
            def body(m, _):
                return predict(params, m, conditions, geometry), None

            out, _ = jax.lax.scan(body, materials, None, length=n_timed)
            return out[:1, :1, :1, :1]

        jax.block_until_ready(chain(params, *batch))  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(chain(params, *batch))
            best = min(best, (time.perf_counter() - t0) / n_timed)
        return best

    t_b1 = bench_batch(1)

    # batch-1 wall including the device->host fetch of the prediction
    best_fetch = float("inf")
    b1 = init_batch(1)
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(predict(params, *b1))
        best_fetch = min(best_fetch, time.perf_counter() - t0)

    t_bN = bench_batch(B, n_timed=20)

    result = {
        "image_size": S,
        "dtype": dtype,
        "input_dim": input_dim,
        "latency_b1_ms": round(t_b1 * 1e3, 2),
        "latency_b1_fetch_ms": round(best_fetch * 1e3, 2),
        "serving_batch": B,
        "latency_bN_ms": round(t_bN * 1e3, 2),
        "throughput_bN_per_s": round(B / t_bN, 1),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    if emit_json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"{k}: {v}")


if __name__ == "__main__":
    main()
