"""Attribute the flat chunk kernel's per-CG-iteration cost on device.

When the datagen wall is device-bound and the device time is dominated
by the segmented CG loop, the throughput lever is the iteration itself:
band matvec, coarse apply, preconditioner apply. This harness measures the
per-iteration slope directly — two dispatches of the same chunk at
max_iters K_LO and K_HI with a non-convergeable tol, slope =
(t_hi - t_lo) / (K_HI - K_LO) — across preconditioner configs:

  block=0      per-node 2x2 block-Jacobi (+ coarse)  [shipped default]
  block=256    band-block Jacobi, bf16 Gram factor   (FEA_TPU_BAND_BLOCK)
  block=512    ditto, larger blocks
  block=256/nc0  band-block Jacobi, coarse level disabled
  block=0/nc0    2x2 only — isolates the coarse apply's share

Combined with the measured iteration-count ratios (tests/test_banded.py,
CPU study: 2x2 -> block256 is ~1.4-1.7x fewer iterations at production
density), per-iteration slope decides whether band-block Jacobi ships as
default. Usage:

  python benchmarks/iteration_profile.py [mesh_size] [n_plates] [configs]
"""
import os
import sys
import time

from fea_tpu.utils.device import enable_compilation_cache

enable_compilation_cache()
import jax

from fea_tpu.datagen.batched import (
    PlateSolver,
    RunningBuckets,
    dispatch_plate_group,
)
from fea_tpu.datagen.conditions import ConditionSampler
from fea_tpu.fem.problem import StaticProblem
from fea_tpu.geometry import GeometrySampler
from fea_tpu.mesh import triangulate_polygon

mesh_size = float(sys.argv[1]) if len(sys.argv) > 1 else 1e-2
n_plates = int(sys.argv[2]) if len(sys.argv) > 2 else 4
K_LO, K_HI = 10, 160  # both below the 180-iteration stall limit

gs = GeometrySampler(random_seed=5)
cs = ConditionSampler(random_seed=6)
buckets = RunningBuckets()
jobs = []
while len(jobs) < n_plates:
    try:
        poly = gs.generate()
        mesh = triangulate_polygon(poly, mesh_size=mesh_size)
        conds = cs.sample(mesh, 4)
    except Exception:
        continue
    pairs = []
    for c in conds:
        p = StaticProblem.from_condition(
            mesh,
            material_regions=c["material_regions"],
            point_constraints=c["point_constraints"],
            edge_constraints=c["edge_constraints"],
            point_forces=c["point_forces"],
            edge_forces=c["edge_forces"],
            num_steps=6,
        )
        if not p.structurally_singular():
            pairs.append(p)
    if len(pairs) < 4:
        continue
    jobs.append((mesh, pairs[:4]))
buckets.update(m for m, _ in jobs)


def build_payloads():
    solvers = [
        PlateSolver(
            m, 6, node_bucket=buckets.node, tri_bucket=buckets.tri,
            include_cell_fields=False, restarts=1,
        )
        for m, _ in jobs
    ]
    wmax = max(s.slots_dev.shape[1] for s in solvers)
    hmax = max(s.band_hb for s in solvers)
    solvers = [
        PlateSolver(
            m, 6, node_bucket=buckets.node, tri_bucket=buckets.tri,
            min_incidence_degree=wmax,
            band_hb=hmax if min(s.band_hb for s in solvers) > 0 else -1,
            include_cell_fields=False, restarts=1,
        )
        for m, _ in jobs
    ]
    return [(s, pairs) for s, (_, pairs) in zip(solvers, jobs)]


payloads = build_payloads()
hb = payloads[0][0].band_hb
print(
    f"chunk: {n_plates} plates x 4 conds, node_bucket={buckets.node} "
    f"tri_bucket={buckets.tri} band_hb={hb}",
    file=sys.stderr,
)


def timed_dispatch(pl_, iters):
    t0 = time.time()
    tok = dispatch_plate_group(
        pl_, pad_group_to=n_plates, tol=1e-30, max_iters=iters
    )
    tok.block_until_ready()
    return time.time() - t0


_OFF = {
    "FEA_TPU_BAND_BLOCK": "0",
    "FEA_TPU_COARSE_FUSED": "0",
    "FEA_TPU_COARSE_BLOCK": "0",
}
CONFIGS = [
    ("block=0", _OFF, None),
    ("block=0 fused", dict(_OFF, FEA_TPU_COARSE_FUSED="1"), None),
    ("block=256", dict(_OFF, FEA_TPU_BAND_BLOCK="256"), None),
    ("block=512", dict(_OFF, FEA_TPU_BAND_BLOCK="512"), None),
    ("block=256 nc=0", dict(_OFF, FEA_TPU_BAND_BLOCK="256"), 0),
    ("block=0 nc=0", _OFF, 0),
    # blkagg rebuilds the payloads: FEA_TPU_COARSE_BLOCK is consulted at
    # PlateSolver table build (contiguous equal-size RCM blocks), not
    # only at dispatch (fem/coarse.build_block_aggregates).
    ("blkagg", dict(_OFF, FEA_TPU_COARSE_BLOCK="1"), None),
]
only = sys.argv[3].split(",") if len(sys.argv) > 3 else None
if only:
    CONFIGS = [c for c in CONFIGS if c[0] in only]

results = {}
for name, env, nc_override in CONFIGS:
    for k, v in env.items():
        os.environ[k] = v
    pl = payloads
    if env.get("FEA_TPU_COARSE_BLOCK") == "1":
        # Blocked aggregates are baked into the PlateSolver tables at
        # build time; rebuild under the env so both build and dispatch
        # see it. Same meshes/buckets -> identical shapes, fair A/B.
        pl = build_payloads()
    saved = [s.n_coarse for s, _ in pl]
    if nc_override is not None:
        for s, _ in pl:
            s.n_coarse = nc_override
    try:
        timed_dispatch(pl, K_LO)  # compile both programs
        timed_dispatch(pl, K_HI)
        # Host-clock noise can swamp a per-pair slope: take the min over
        # repeats PER K — the noise floor of each endpoint — then one
        # slope between the two floors.
        t_lo = min(timed_dispatch(pl, K_LO) for _ in range(4))
        t_hi = min(timed_dispatch(pl, K_HI) for _ in range(4))
        slope = (t_hi - t_lo) / (K_HI - K_LO)
        results[name] = slope * 1e3
        print(
            f"{name:>16}: {slope * 1e3:.3f} ms/iteration "
            f"(t@{K_LO}={t_lo:.3f}s t@{K_HI}={t_hi:.3f}s)",
            file=sys.stderr,
        )
    finally:
        for (s, _), v in zip(pl, saved):
            s.n_coarse = v

print({"ms_per_iteration": {k: round(v, 4) for k, v in results.items()},
       "n_plates": n_plates, "lanes": 4 * n_plates,
       "node_bucket": buckets.node, "band_hb": hb})
