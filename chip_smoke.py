"""End-to-end smoke run of fea_tpu on an NVIDIA GPU, in one process.

    python chip_smoke.py [--out DIR]     # phases 0-6 on one card
    python chip_smoke.py --chips 4       # DP train step + sharded datagen, 4 cards

Phases on one card, each through the entry point a user calls
(`fea_tpu.cli.main`), at the flagship's full width:

  0 device     the card, its power limit, the compile cache, the native mesher
  1 datagen    `generate --batched` at the production config; 8 conditions
               re-solved with the host f64 SuperLU (fem/direct.py)
  2 fem        the gusset golden (10,388 nodes) through solve_refined; every
               device matrix product of fem/ pins its precision
  3 train      `train` at input_dim 64, 256 px, batch 16, f32 and bf16;
               the final checkpoint is written and read back; attention
               variants timed at the inner stage's shapes
  4 parity     the trained surrogate at default precision and in bf16
               against the float32 forward under precision "highest"
  5 serve      `app gusset --checkpoint ...`: GT solve, raster, surrogate
  6 card tests the tests marked `gpu` (tests/test_gpu.py)

Any failed phase or check exits non-zero without the result line. The
last line of stdout is the result:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Only one process may use a card: JAX reserves most of its memory.
"""

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


@dataclass(frozen=True)
class Sizes:
    plates: int = 8
    image: int = 512
    mesh: float = 1e-2
    conditions: int = 4
    steps: int = 6
    ref_conditions: int = 8
    train_image: int = 256
    batch: int = 16
    input_dim: int = 64
    train_steps: int = 3
    timed_steps: int = 10
    parity_batch: int = 4
    attention_tokens: tuple = (1024, 4096)
    attention_batch: int = 16


# Counted by jax.eval_shape from the trio in fea_tpu/models at input_dim
# 64, 4 stages, 256 px (tests/test_models.py pins the same numbers).
FLAGSHIP_PARAMS = {"encoder": 41_093_440, "decoder": 18_471_106,
                   "auxiliary": 134_417_416}


# ---------------------------------------------------------------- phase 0
def card_line():
    """Name and power limit of the card, from nvidia-smi (a child process
    that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def phase_device():
    import jax

    from fea_tpu.mesh.mesher import native_mesher_loaded
    from fea_tpu.utils.device import enable_compilation_cache

    devices = jax.devices()
    d = devices[0]
    check(d.platform == "gpu", f"no GPU: JAX found {d.platform}")
    cache = enable_compilation_cache()
    say(0, f"platform={d.platform} kind={d.device_kind} count={len(devices)} "
           f"jax={jax.__version__} compile_cache={cache}")
    say(0, f"card: {card_line()}")
    check(native_mesher_loaded(), "native CDT mesher did not load")
    say(0, "native CDT mesher loaded")
    return d


# ---------------------------------------------------------------- phase 1
def capture_conditions(store, limit):
    """Record (mesh, condition, result) of the first `limit` conditions
    the datagen writes, by wrapping its condition writer."""
    from fea_tpu.datagen import pipeline

    original = pipeline._write_condition

    def recording(mesh, pixel_map, condition, result, *a, **kw):
        if len(store) < limit:
            store.append((mesh, condition, result))
        return original(mesh, pixel_map, condition, result, *a, **kw)

    pipeline._write_condition = recording
    return lambda: setattr(pipeline, "_write_condition", original)


def check_layout(data_dir, sz):
    for plate in range(1, sz.plates + 1):
        pdir = data_dir / str(plate)
        for name in ("input.png", "outline.png"):
            check((pdir / name).is_file(), f"missing {pdir / name}")
        for cond in range(1, sz.conditions + 1):
            cdir = pdir / str(cond)
            for name in ("magnitudes.txt", "materials.txt", "ranges.txt",
                         "outputs_displacement_x.png",
                         "outputs_displacement_y.png"):
                check((cdir / name).is_file(), f"missing {cdir / name}")
            regions = list(cdir.glob("regions_*.png"))
            check(regions, f"no regions_*.png in {cdir}")
            ranges = (cdir / "ranges.txt").read_text().splitlines()
            check(len(ranges) == 2 * (sz.steps - 1),
                  f"{cdir}/ranges.txt has {len(ranges)} lines")


def phase_datagen(out, sz):
    from fea_tpu import cli
    from fea_tpu.datagen.pipeline import DATAGEN_ACCEPT_TOL
    from fea_tpu.fem.direct import direct_solve_u1
    from fea_tpu.fem.problem import StaticProblem

    data_dir = out / "data"
    kept = []
    restore = capture_conditions(kept, max(sz.ref_conditions, 8))
    t0 = time.perf_counter()
    try:
        stats = cli.main([
            "generate", "--batched", "--num_plates", str(sz.plates),
            "--conditions_per_plate", str(sz.conditions),
            "--steps_per_condition", str(sz.steps),
            "--mesh_size", str(sz.mesh), "--image_size", str(sz.image),
            "--save_displacement", "--data_dir", str(data_dir),
            "--seed", "1234",
        ])
    finally:
        restore()
    wall = time.perf_counter() - t0
    check(stats["plates"] == sz.plates, f"wrote {stats['plates']} plates")
    check_layout(data_dir, sz)
    say(1, f"layout complete: {sz.plates} plates x {sz.conditions} conditions")
    say(1, "stats " + json.dumps({
        "wall_s": wall,
        "solves": stats.get("solves"),
        "cg_failures": stats.get("cg_failures"),
        "direct_fallbacks": stats.get("direct_fallbacks"),
        "cg_resamples": stats.get("cg_resamples"),
        "device_busy_s": stats.get("device_busy_s"),
    }))

    check(len(kept) >= sz.ref_conditions,
          f"captured {len(kept)} conditions, need {sz.ref_conditions}")
    worst = 0.0
    for mesh, cond, result in kept[: sz.ref_conditions]:
        problem = StaticProblem.from_condition(
            mesh,
            material_regions=cond["material_regions"],
            point_constraints=cond["point_constraints"],
            edge_constraints=cond["edge_constraints"],
            point_forces=cond["point_forces"],
            edge_forces=cond["edge_forces"],
            num_steps=sz.steps,
        )
        u_ref, finite, _ = direct_solve_u1(problem)
        check(finite, "f64 SuperLU found a kept condition singular")
        u = np.asarray(result.displacements[-1], np.float64)
        err = np.abs(u - u_ref).max() / max(np.abs(u_ref).max(), 1e-300)
        worst = max(worst, err)
    say(1, f"reference check: {sz.ref_conditions} conditions vs f64 SuperLU, "
           f"max relative error (max-norm) {worst:.3e} "
           f"(bound DATAGEN_ACCEPT_TOL={DATAGEN_ACCEPT_TOL})")
    check(worst <= DATAGEN_ACCEPT_TOL, f"datagen error {worst:.3e}")
    return data_dir


# ---------------------------------------------------------------- phase 2
_PRODUCTS = {"einsum", "dot", "matmul", "tensordot", "dot_general", "inner",
             "vdot"}


def device_products(path):
    """(device products, of which precision-pinned, host products) in a
    module: jnp/lax product calls are device code, np ones host f64."""
    import ast

    tree = ast.parse(Path(path).read_text())
    device = pinned = host = 0
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _PRODUCTS
                and isinstance(node.func.value, ast.Name)):
            continue
        owner = node.func.value.id
        if owner in ("jnp", "lax"):
            device += 1
            pinned += any(k.arg == "precision" for k in node.keywords)
        elif owner == "np":
            host += 1
    return device, pinned, host


def unpinned_fem_products():
    bad = []
    for path in sorted((ROOT / "fea_tpu" / "fem").glob("*.py")):
        device, pinned, host = device_products(path)
        if device != pinned:
            bad.append(f"{path.name}: {device - pinned} of {device}")
    return bad


def phase_fem():
    import jax

    from fea_tpu.datagen.pipeline import next_bucket
    from fea_tpu.fem import StaticProblem
    from fea_tpu.fem.problem import solve_refined

    for name in ("banded.py", "problem.py", "assembly.py", "direct.py"):
        device, pinned, host = device_products(ROOT / "fea_tpu" / "fem" / name)
        say(2, f"{name}: {device} device products, {pinned} with precision=, "
               f"{host} host (f64 numpy) products")
    bad = unpinned_fem_products()
    check(not bad, f"unpinned device products: {bad}")

    g = np.load(ROOT / "tests" / "goldens" / "gusset_golden.npz")
    m = len(g["triangles"])
    problem = StaticProblem(
        coords=g["coords"], triangles=g["triangles"],
        young=np.full(m, 210000.0), poisson=np.full(m, 0.3),
        fixed_nodes=g["fixed"], loads=g["loads"], num_steps=2,
    )
    pads = (next_bucket(len(g["coords"]) + 3), next_bucket(m))
    t0 = time.perf_counter()
    res = solve_refined(problem, pad_buckets=pads)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve_refined(problem, pad_buckets=pads)
    warm = time.perf_counter() - t0
    u = np.asarray(res.displacements[-1])
    rel_mae = np.abs(u - g["u"]).mean() / np.abs(g["u"]).max()
    say(2, f"gusset {len(g['coords'])} nodes on {jax.devices()[0].platform}: "
           f"relative MAE {rel_mae:.3e} (bound 1e-5), "
           f"solve_refined {first:.2f} s cold, {warm:.2f} s warm")
    check(rel_mae <= 1e-5, f"gusset relative MAE {rel_mae:.3e}")


# ---------------------------------------------------------------- phase 3
class CompileClock:
    """Sums XLA backend-compile seconds reported by jax.monitoring."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax.monitoring

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event == self.EVENT:
            self.total += duration


def train_args(data_dir, results, sz, dtype):
    args = [
        "train", "--data_dir", str(data_dir),
        "--sample_data_dir", str(data_dir),
        "--image_size", str(sz.train_image), "--batch_size", str(sz.batch),
        "--num_steps", str(sz.train_steps),
        "--num_steps_per_milestone", "1000000",
        "--num_steps_per_condition", str(sz.steps),
        "--num_steps_per_sample_condition", str(sz.steps),
        "--conditions_per_plate", str(sz.conditions),
        "--num_sample_conditions_per_plate", "1",
        "--results_dir", str(results), "--input_dim", str(sz.input_dim),
        "--skip_dataset_size_check", "--no_progress_bar",
    ]
    if dtype == "bfloat16":
        args += ["--compute_dtype", "bfloat16"]
    return args


def time_steps(trainer, n):
    import jax

    batch = trainer._fetch_batch(0)
    state = trainer.state
    for _ in range(2):  # warm: compiled by the CLI run, buffers settle
        state, loss = trainer._train_step(state, batch)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(n):
        state, loss = trainer._train_step(state, batch)
    jax.block_until_ready(state)
    rate = n / (time.perf_counter() - t0)
    compiled = trainer._train_step.lower(state, batch).compile()
    trainer.state = state
    return rate, compiled.memory_analysis()


def phase_train(out, data_dir, sz, clock):
    import jax

    from fea_tpu import cli
    from fea_tpu.utils.logs import parse_train_log

    ckpt = None
    for dtype in ("float32", "bfloat16"):
        results = out / f"results_{dtype}"
        c0 = clock.total
        t0 = time.perf_counter()
        trainer = cli.main(train_args(data_dir, results, sz, dtype))
        wall = time.perf_counter() - t0
        compile_s = clock.total - c0
        check(trainer.num_params() == FLAGSHIP_PARAMS,
              f"parameter counts {trainer.num_params()}")
        logs = sorted(results.glob("train-*.log"))
        losses = parse_train_log(str(logs[-1]))["losses"]
        check(len(losses) == sz.train_steps and np.isfinite(losses).all(),
              f"{dtype} losses {losses}")
        if dtype == "float32":
            final = results / "model-final"
            check((final / "checkpoint.npz").is_file(), "no final checkpoint")
            before = jax.device_get(trainer.state)
            trainer.load_checkpoint("final")
            after = jax.device_get(trainer.state)
            same = all(
                np.array_equal(a, b) for a, b in
                zip(jax.tree.leaves(before), jax.tree.leaves(after))
            )
            check(same, "checkpoint read back differs from the saved state")
            say(3, f"checkpoint {final} written and read back identically")
            ckpt = final
            (results / "model-final.zip").unlink()  # ~2.3 GB of disk
        rate, mem = time_steps(trainer, sz.timed_steps)
        stats = jax.devices()[0].memory_stats() or {}
        say(3, f"{dtype}: params {trainer.num_params()}, CLI run {wall:.1f} s "
               f"of which XLA compile {compile_s:.1f} s; "
               f"{rate:.3f} steps/s at b{sz.batch} {sz.train_image}px after "
               f"warm-up; losses {losses.tolist()}")
        say(3, f"{dtype}: memory_analysis {mem}")
        say(3, f"{dtype}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
        if dtype == "bfloat16":
            shutil.rmtree(results)  # its checkpoint is not used further
        del trainer
        gc.collect()
    return ckpt


def time_attention(sz):
    """The attention variant's full-attention stage at its real shapes:
    einsum chain vs jax.nn.dot_product_attention (XLA, cuDNN), forward +
    backward, median of 5 timed runs."""
    import jax
    import jax.numpy as jnp

    from fea_tpu.models.attention import softmax_attention

    heads, d = 4, 32
    rows = []
    for n in sz.attention_tokens:
        m = n + 4  # 4 learned memory key/values
        for dtype in ("float32", "bfloat16"):
            k1, k2, k3 = jax.random.split(jax.random.PRNGKey(n), 3)
            shape_q = (sz.attention_batch, heads, n, d)
            shape_k = (sz.attention_batch, heads, m, d)
            q = jax.random.normal(k1, shape_q, dtype)
            k = jax.random.normal(k2, shape_k, dtype)
            v = jax.random.normal(k3, shape_k, dtype)
            impls = {"einsum": softmax_attention}
            for impl in ("xla", "cudnn"):
                def dpa(q, k, v, impl=impl):
                    t = lambda x: x.transpose(0, 2, 1, 3)  # -> (B, T, N, H)
                    o = jax.nn.dot_product_attention(
                        t(q), t(k), t(v), implementation=impl
                    )
                    return t(o)
                impls[impl] = dpa
            for name, fn in impls.items():
                step = jax.jit(jax.value_and_grad(
                    lambda q, k, v, fn=fn: fn(q, k, v).astype(jnp.float32).sum(),
                    argnums=(0, 1, 2),
                ))
                try:
                    jax.block_until_ready(step(q, k, v))
                except Exception as e:
                    if (name, dtype) != ("cudnn", "float32"):
                        raise
                    # cuDNN's flash attention takes half precision only
                    rows.append((n, m, dtype, name, None, str(e).split("\n")[0][:120]))
                    continue
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    for _ in range(10):
                        r = step(q, k, v)
                    jax.block_until_ready(r)
                    times.append((time.perf_counter() - t0) / 10)
                rows.append((n, m, dtype, name, float(np.median(times)), ""))
    for n, m, dtype, name, t, err in rows:
        timing = f"{t * 1e3:.3f} ms" if t is not None else f"failed: {err}"
        say(3, f"attention b{sz.attention_batch} h4 d32 q{n} kv{m} {dtype} "
               f"{name} fwd+bwd {timing}")


# ---------------------------------------------------------------- phase 4
def phase_parity(out, data_dir, ckpt, sz):
    import jax
    import jax.numpy as jnp

    from fea_tpu.data import FEADataset
    from fea_tpu.data.dataset import collate
    from fea_tpu.models import create_models
    from fea_tpu.train.checkpoint import load_flat, unflatten

    params = unflatten(load_flat(ckpt, ("params/",)))["params"]
    enc, dec, aux = create_models(
        input_dim=sz.input_dim, image_height=sz.train_image,
        image_width=sz.train_image, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=4,
    )
    ds = FEADataset(str(data_dir), image_size=sz.train_image,
                    conditions_per_plate=sz.conditions, num_steps=sz.steps)
    batch = collate([ds[i] for i in range(sz.parity_batch)])
    cond = np.concatenate([batch["forces"], batch["constraints"]], axis=-1)

    def forward(params, materials, conditions, dtype):
        cast = lambda t: jax.tree.map(lambda a: a.astype(dtype), t)
        x, hidden, residual = enc.apply(
            {"params": cast(params["encoder"])}, cast(materials),
            cast(conditions),
        )
        image = dec.apply({"params": cast(params["decoder"])}, x,
                          list(hidden), residual)
        sign, log = aux.apply({"params": cast(params["auxiliary"])}, x)
        return tuple(o.astype(jnp.float32) for o in (image, sign, log))

    args = (params, batch["materials"], cond)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(forward, static_argnums=3)(*args, jnp.float32)
    runs = {
        "float32 default precision": jax.jit(forward, static_argnums=3)(
            *args, jnp.float32),
        "bfloat16": jax.jit(forward, static_argnums=3)(*args, jnp.bfloat16),
    }
    # Bounds on the relative L2 error of every head, set from H100 readings.
    # Float32 convolutions at default precision may run as TF32 on this card:
    # they read at most 8.3e-4, and a forward in bf16 at least 2.6e-3, so
    # 1.5e-3 passes TF32 and refuses a forward that quietly ran in bf16.
    # bfloat16 reads at most 1.1e-2; 1e-1 refuses a broken forward (O(1)).
    bounds = {"float32 default precision": 1.5e-3, "bfloat16": 1e-1}
    for name, got in runs.items():
        for head, a, b in zip(("image", "sign", "log"), got, ref):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            check(np.isfinite(a).all(), f"{name} {head}: non-finite")
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            say(4, f"{name} {head}: max-abs {np.abs(a - b).max():.3e} "
                   f"rel-L2 {rel:.3e} (bound {bounds[name]})")
            check(rel <= bounds[name], f"{name} {head} rel-L2 {rel:.3e}")


# ---------------------------------------------------------------- phase 5
def phase_serve(out, ckpt):
    from fea_tpu import cli

    app_dir = out / "app_gusset"
    argv = ["app", "gusset", "--checkpoint", str(ckpt),
            "--output_dir", str(app_dir)]
    t0 = time.perf_counter()
    cli.main(argv)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = cli.main(argv)
    warm = time.perf_counter() - t0
    for name in ("predicted_displacement_x.png", "predicted_displacement_y.png",
                 "gusset.vtk", "predicted.vtk"):
        check((app_dir / name).is_file(), f"missing {app_dir / name}")
    check(np.isfinite(report["pred_mae"]), f"pred_mae {report['pred_mae']}")
    say(5, f"app gusset: {report['nodes']} nodes, one analysis {warm:.2f} s "
           f"after warm-up ({cold:.2f} s cold); predict_wall_s "
           f"{report['predict_wall_s']}; pred_mae {report['pred_mae']:.4f}")


# ---------------------------------------------------------------- phase 6
def phase_card_tests():
    import pytest

    class Count:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            if report.skipped:
                Count.skipped += 1

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         str(ROOT / "tests" / "test_gpu.py")],
        plugins=[Count()],
    )
    say(6, f"card tests: exit {rc}, {Count.passed} passed, "
           f"{Count.skipped} skipped")
    check(rc == 0 and Count.passed > 0 and Count.skipped == 0,
          "card tests failed or skipped")


# ------------------------------------------------------------- four cards
class RandomDataset:
    """Deterministic random training samples (the dataset contract's keys
    and shapes) for the DP step comparison."""

    def __init__(self, n, size, seed=0):
        self.n, self.size, self.seed = n, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(self.seed + i)
        s = self.size
        return {
            "materials": r.normal(size=(s, s, 2)).astype(np.float32),
            "forces": r.normal(size=(s, s, 2)).astype(np.float32),
            "constraints": np.where(r.random((s, s, 1)) > 0.9, 1.0, -1.0).astype(np.float32),
            "geometry": np.where(r.random((s, s, 1)) > 0.3, 1.0, -1.0).astype(np.float32),
            "displacement": r.uniform(-1, 1, (s, s, 2)).astype(np.float32),
            "sign_displacement_range": r.random(4).astype(np.float32),
            "log_displacement_range": r.random(4).astype(np.float32),
        }


def dp_step(n_devices, sz, out):
    import jax

    from fea_tpu.train.trainer import Trainer, TrainerConfig

    ds = RandomDataset(64, sz.train_image)
    cfg = TrainerConfig(
        dataset_image_size=sz.train_image, train_batch_size=sz.batch,
        num_train_steps=1, input_dim=sz.input_dim,
        num_steps_per_condition=sz.steps,
        num_steps_per_sample_condition=sz.steps,
        skip_dataset_size_check=True, progress_bar=False,
        results_folder=str(out / f"dp{n_devices}"), n_devices=n_devices,
        disable_auxiliary=False, seed=0,
    )
    trainer = Trainer(cfg, dataset=ds, sample_dataset=ds)
    batch = trainer._fetch_batch(0)
    shards = len(batch["materials"].addressable_shards)
    check(shards == n_devices, f"batch on {shards} devices, want {n_devices}")
    with jax.default_matmul_precision("highest"):
        state, loss = trainer._train_step(trainer.state, batch)
    return float(loss), first_moments(state)


def first_moments(state):
    """Adam's first moment after one step, (1 - b1) * clipped gradient: linear
    in the all-reduced gradient, unlike the step itself. By key path."""
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax.device_get(state.opt_states))
    return {
        jax.tree_util.keystr(path): np.asarray(leaf, np.float64)
        for path, leaf in flat
        if any(getattr(k, "name", None) == "mu" for k in path)
    }


def moment_difference(m1, mn):
    """(global relative L2, worst leaf relative L2, its path, leaves
    compared). Leaves whose one-card norm is under 1e-6 of the largest
    leaf's hold only rounding (e.g. biases that a normalization cancels)
    and are skipped in the per-leaf worst."""
    check(m1.keys() == mn.keys(), "optimizer trees differ between meshes")
    norms = {k: np.linalg.norm(v) for k, v in m1.items()}
    diffs = {k: np.linalg.norm(mn[k] - m1[k]) for k in m1}
    total = np.sqrt(sum(d * d for d in diffs.values()))
    total /= np.sqrt(sum(n * n for n in norms.values()))
    floor = 1e-6 * max(norms.values())
    rel = {k: diffs[k] / norms[k] for k in m1 if norms[k] > floor}
    worst = max(rel, key=rel.get)
    return float(total), float(rel[worst]), worst, len(rel)


def sharded_datagen(n_devices, sz, out):
    from fea_tpu.datagen.batched import generate_data_batched

    kept = []
    restore = capture_conditions(kept, 10**6)
    try:
        stats = generate_data_batched(
            data_dir=str(out / f"dg{n_devices}"), image_size=sz.image,
            num_plates=sz.plates, conditions_per_plate=sz.conditions,
            mesh_size=sz.mesh, num_steps_per_condition=sz.steps,
            save_displacement=True, seed=77, batch_size=4,
            n_devices=n_devices, verbose=False,
        )
    finally:
        restore()
    return stats, [np.asarray(r.displacements[-1]) for _, _, r in kept]


# The same f32 program at precision "highest" on both meshes; only the
# order of the loss and gradient reductions differs. A gradient that missed
# the all-reduce, or came from one card's rows, moves Adam's first moment
# by O(1). Worst-leaf readings: 5.0e-5 between 1 and 4 H100s; 6.7 for a
# gradient from one device's rows (4 CPU devices, input_dim 8).
DP_LOSS_BOUND = 1e-5
DP_MOMENT_BOUND = 1e-3


def phase_four_cards(out, sz, n):
    import jax

    check(len(jax.devices()) >= n, f"need {n} devices, have {len(jax.devices())}")
    l1, m1 = dp_step(1, sz, out)
    ln, mn = dp_step(n, sz, out)
    dl = abs(ln - l1) / abs(l1)
    total, worst, where, leaves = moment_difference(m1, mn)
    say("4-card", f"DP train step global batch {sz.batch}: loss 1 card "
                  f"{l1:.6f}, {n} cards {ln:.6f} (rel diff {dl:.2e}, bound "
                  f"{DP_LOSS_BOUND})")
    say("4-card", f"Adam first moment (clipped gradient), {leaves} leaves: "
                  f"rel-L2 all leaves {total:.3e}, worst leaf {worst:.3e} at "
                  f"{where} (bound {DP_MOMENT_BOUND})")
    check(dl <= DP_LOSS_BOUND and worst <= DP_MOMENT_BOUND,
          "DP step differs between meshes")

    s1, u1 = sharded_datagen(1, sz, out)
    sn, un = sharded_datagen(n, sz, out)
    keys = ("plates", "solves", "cg_failures", "direct_fallbacks",
            "cg_resamples", "continuations")
    say("4-card", "datagen 1 card " + json.dumps({k: s1.get(k) for k in keys}))
    say("4-card", f"datagen {n} cards " + json.dumps({k: sn.get(k) for k in keys}))
    check(s1["solves"] == sn["solves"] and len(u1) == len(un),
          "solve counts differ between 1 and 4 cards")
    worst = max(
        np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        for a, b in zip(u1, un)
    )
    # Both are f32 CG solutions accepted at relative residual
    # DATAGEN_ACCEPT_TOL (2e-3), each within ~2e-3 (max-norm) of the f64
    # truth, so they may differ by twice that.
    say("4-card", f"datagen displacements, {len(u1)} conditions: max relative "
                  f"difference (max-norm) {worst:.3e} (bound 4e-3)")
    check(worst <= 4e-3, "sharded datagen displacements differ")


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default=None,
                    help="directory for datasets, checkpoints and app "
                         "images (default: a temporary directory, removed "
                         "at the end)")
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    sz = Sizes()
    out = Path(args.out) if args.out else Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    out.mkdir(parents=True, exist_ok=True)
    for stale in ("data", "results_float32", "results_bfloat16",
                  "app_gusset", "dg1", f"dg{args.chips}", "dp1",
                  f"dp{args.chips}"):
        shutil.rmtree(out / stale, ignore_errors=True)  # a previous run's
    start = time.perf_counter()
    phase = 0
    try:
        device = phase_device()
        import jax

        if args.chips > 1:
            phase = "4-card"
            phase_four_cards(out, sz, args.chips)
        else:
            clock = CompileClock()
            phase = 1
            data_dir = phase_datagen(out, sz)
            phase = 2
            phase_fem()
            phase = 3
            ckpt = phase_train(out, data_dir, sz, clock)
            time_attention(sz)
            phase = 4
            phase_parity(out, data_dir, ckpt, sz)
            phase = 5
            phase_serve(out, ckpt)
            phase = 6
            phase_card_tests()
        say("done", f"all phases passed in {time.perf_counter() - start:.1f} s")
    except Exception as e:  # report the phase, then fail
        import traceback

        traceback.print_exc()
        print(f"FAILED in phase {phase}: {type(e).__name__}: {e}", flush=True)
        return 1
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    count = len(jax.devices())
    check(count == args.chips, f"{count} devices visible, ran for {args.chips}")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
