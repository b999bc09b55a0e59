"""Device-resident plate solving: upload the padded mesh scaffold once per
plate, dispatch per-condition solves asynchronously, fetch packed results.

This is the throughput core of datagen: the reference pays a fresh sfepy
problem build + SuperLU factorization per condition per step
(fea_analysis.py:418-461); here a plate's mesh lives on device and each
condition is one async packed PCG solve (~100 KB of traffic round trip).
`generate_data_batched` additionally groups same-bucket plates and vmaps
the solve across them — the multi-plate scale-out surface for larger
meshes of devices.
"""

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from functools import lru_cache, partial

from ..fem.assembly import build_incidence
from ..fem.banded import (
    quantize_hb,
    rcm_permutation,
)
from ..fem.coarse import (
    build_aggregates,
    build_block_aggregates,
    n_coarse_for_bucket,
)
from ..fem.direct import direct_solve
from ..fem.problem import (
    SolveResult,
    StaticProblem,
    _solve_kernel_packed,
    _solve_core,
    unpack_solve,
)
from ..mesh import Mesh
from .pipeline import DATAGEN_ACCEPT_TOL, next_bucket


def _use_flat_chunk() -> bool:
    """Flat super-mesh chunk kernel toggle (default on; set
    FEA_TPU_FLAT_CHUNK=0 to fall back to the two-level vmap kernel)."""
    import os

    return os.environ.get("FEA_TPU_FLAT_CHUNK", "1") != "0"


def _use_banded() -> bool:
    """Banded CG operator toggle (default on; set FEA_TPU_BANDED=0 to
    fall back to the incidence gather-sum operator)."""
    import os

    return os.environ.get("FEA_TPU_BANDED", "1") != "0"


def _band_block() -> int:
    """Band-block Jacobi smoother size in dofs (flat banded kernel only;
    fem/banded.band_block_diagonal). 0 disables — the per-node 2x2
    block-Jacobi is used instead. FEA_TPU_BAND_BLOCK overrides."""
    import os

    return int(os.environ.get("FEA_TPU_BAND_BLOCK", "0"))


def _coarse_fused() -> bool:
    """Fused (N,3) restriction/prolongation in the flat kernel's coarse
    apply (one scatter-add + one gather instead of 3 + 3). The segment
    ops are 48% of the shipped per-iteration cost
    (benchmarks/iteration_profile.py); FEA_TPU_COARSE_FUSED toggles the
    A/B. Read per dispatch: it lands in the kernel's static kwargs, so
    toggling forces the distinct compilation it needs."""
    import os

    return os.environ.get("FEA_TPU_COARSE_FUSED", "0") != "0"


def _coarse_block() -> bool:
    """Block (contiguous equal-size) aggregation for the coarse space on
    the RCM-banded path: restriction/prolongation become reshapes — zero
    segment/gather ops in the CG hot loop (fem/coarse.py
    build_block_aggregates + flatgroup.coarse_apply_flat blocked path).
    FEA_TPU_COARSE_BLOCK=0 opts out (geometric grid-bin aggregates).
    Consulted both at PlateSolver table build and at dispatch; the
    dispatch flag additionally requires band_hb > 0, which is exactly
    when the solver built blocked tables, so the pair cannot skew."""
    import os

    return os.environ.get("FEA_TPU_COARSE_BLOCK", "0") != "0"


# Hard cap on the banded half-bandwidth. The band buffer is
# n_dofs x (2*hb + BAND_R) floats PER LANE (fem/banded.py): at the
# production node bucket (8192) that is ~42 MB/lane at hb 256 but
# ~277 MB/lane at the old node_bucket//4 bound (2048) — one
# high-bandwidth outlier mesh ratcheting `RunningBuckets.band` up was
# enough to OOM a 16 GB chip with 3 chunks in flight (observed at plate
# ~843 of the first 4000-plate production run). Typical RCM dof
# half-bandwidths at mesh_size 1e-2 are 105-239; capped plates ride
# dedicated incidence-operator chunks instead (see dispatch_chunk's
# band-class grouping).
BAND_HB_CAP = 384


@partial(
    jax.jit,
    static_argnames=(
        "tol", "max_iters", "accept_tol", "restarts", "include_cell_fields",
        "n_coarse",
    ),
)
def _solve_batch_kernel(
    coords,
    triangles,
    incidence_slots,
    agg_ids,
    arms,
    young_b,
    poisson_b,
    free_b,
    loads_b,
    *,
    tol: float,
    max_iters: int,
    accept_tol: float,
    restarts: int,
    include_cell_fields: bool = True,
    n_coarse: int = 0,
):
    """vmap of the packed solve over conditions sharing one mesh scaffold.
    One dispatch + one fetch for a whole batch of conditions (or plates of
    the same bucket when the mesh args are batched too)."""

    def single(young, poisson, free, loads):
        res, eps1, sig1 = _solve_core(
            coords, triangles, young, poisson, incidence_slots, free, loads,
            tol, max_iters, accept_tol, restarts,
            agg_ids=agg_ids, arms=arms, n_coarse=n_coarse,
        )
        f32 = jnp.float32
        parts = [res.x.reshape(-1).astype(f32)]
        if include_cell_fields:
            parts += [
                eps1.reshape(-1).astype(f32), sig1.reshape(-1).astype(f32)
            ]
        parts.append(
            jnp.stack(
                [
                    res.converged.astype(f32),
                    res.failed.astype(f32),
                    res.residual_norm.astype(f32),
                    res.iterations.astype(f32),
                ]
            )
        )
        return jnp.concatenate(parts)

    return jax.vmap(single)(young_b, poisson_b, free_b, loads_b)


def _failed_result(num_steps: int, n: int, m: int) -> SolveResult:
    zeros_u = np.zeros((num_steps, n, 2))
    zeros_c = np.zeros((num_steps, m, 3))
    return SolveResult(
        displacements=zeros_u,
        strain=zeros_c,
        stress=zeros_c,
        converged=np.asarray(False),
        failed=np.asarray(True),
        residual_norm=np.asarray(np.inf),
        iterations=np.asarray(0),
    )


@partial(
    jax.jit,
    static_argnames=(
        "tol", "max_iters", "accept_tol", "restarts", "include_cell_fields",
        "n_coarse",
    ),
)
def _solve_multi_plate_kernel(
    coords_p,  # (P, Nb, 2)
    triangles_p,  # (P, Mb, 3)
    slots_p,  # (P, 2*Nb, W)
    agg_p,  # (P, Nb)
    arms_p,  # (P, Nb, 2)
    young_pc,  # (P, C, Mb)
    poisson_pc,
    free_pc,  # (P, C, Nb)
    loads_pc,  # (P, C, Nb, 2)
    x0_pc,  # (P, C, Nb, 2) warm start (zeros = cold)
    *,
    tol: float,
    max_iters: int,
    accept_tol: float,
    restarts: int,
    include_cell_fields: bool = True,
    n_coarse: int = 0,
):
    """Two-level vmap: plates (distinct meshes, same bucket) x conditions.
    One dispatch + one fetch for a whole group of plates — the multi-chip
    scale-out surface (shard the plate axis over a 'dp' mesh and XLA runs
    each device's plates independently).

    `x0_pc` warm-starts each lane's PCG: unconverged lanes from a previous
    chunk continue from their partial solution instead of burning the whole
    group's lockstep budget in one dispatch (each re-dispatch recomputes
    the true residual, doubling as iterative refinement)."""

    def single(coords, triangles, slots, agg_ids, arms, young, poisson, free, loads, x0):
        res, eps1, sig1 = _solve_core(
            coords, triangles, young, poisson, slots, free, loads,
            tol, max_iters, accept_tol, restarts,
            agg_ids=agg_ids, arms=arms, n_coarse=n_coarse, x0=x0,
        )
        f32 = jnp.float32
        parts = [res.x.reshape(-1).astype(f32)]
        if include_cell_fields:
            parts += [
                eps1.reshape(-1).astype(f32), sig1.reshape(-1).astype(f32)
            ]
        parts.append(
            jnp.stack(
                [
                    res.converged.astype(f32),
                    res.failed.astype(f32),
                    res.residual_norm.astype(f32),
                    res.iterations.astype(f32),
                ]
            )
        )
        return jnp.concatenate(parts)

    inner = jax.vmap(
        single, in_axes=(None, None, None, None, None, 0, 0, 0, 0, 0)
    )
    outer = jax.vmap(inner, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0))
    return outer(
        coords_p, triangles_p, slots_p, agg_p, arms_p,
        young_pc, poisson_pc, free_pc, loads_pc, x0_pc,
    )


class PlateSolver:
    """Per-plate solver with device-resident padded mesh scaffold."""

    def __init__(
        self,
        mesh: Mesh,
        num_steps: int,
        dtype=jnp.float32,
        tol: Optional[float] = None,
        max_iters: int = 6000,
        accept_tol: float = DATAGEN_ACCEPT_TOL,
        restarts: Optional[int] = None,
        include_cell_fields: bool = True,
        node_bucket: Optional[int] = None,
        tri_bucket: Optional[int] = None,
        min_incidence_degree: int = 0,
        band_hb: int = 0,
    ):
        """`node_bucket`/`tri_bucket`/`min_incidence_degree`/`band_hb` force
        the padded shapes (bumped up if the mesh doesn't fit) so a group of
        plates can share ONE compiled kernel — and hence one dispatch + one
        fetch. `band_hb` is the forced minimum banded half-bandwidth; the
        solver RCM-permutes its scaffold and precomputes the band scatter
        plan whenever banding is enabled (fem/banded.py)."""
        self.mesh = mesh
        self.num_steps = num_steps
        self.n = mesh.num_nodes
        self.m = mesh.num_triangles
        self.node_bucket = max(node_bucket or 0, next_bucket(self.n + 3))
        self.tri_bucket = max(tri_bucket or 0, next_bucket(self.m))
        self._min_incidence_degree = min_incidence_degree
        self.dtype = jnp.dtype(dtype)
        if self.dtype == jnp.float64 and not jax.config.jax_enable_x64:
            self.dtype = jnp.dtype(jnp.float32)
        # Datagen iteration target 1e-5 (f32): measured displacement error at
        # rnorm 1e-5 is ~1e-7..1e-6 relative — polishing to the 1e-6 floor
        # costs ~30-50% more lockstep iterations for precision the uint8
        # image pipeline cannot represent.
        self.tol = tol if tol is not None else (
            1e-10 if self.dtype == jnp.float64 else 1e-5
        )
        self.max_iters = max_iters
        self.accept_tol = accept_tol
        self.restarts = restarts if restarts is not None else (
            1 if self.dtype == jnp.float64 else 6
        )
        self.include_cell_fields = include_cell_fields

        # Build the padded scaffold once from a dummy condition.
        scaffold = StaticProblem(
            coords=np.asarray(mesh.coords),
            triangles=np.asarray(mesh.triangles),
            young=np.zeros(self.m),
            poisson=np.zeros(self.m),
            fixed_nodes=np.zeros(self.n, dtype=bool),
            loads=np.zeros((self.n, 2)),
            num_steps=num_steps,
        ).padded(self.node_bucket, self.tri_bucket)
        self._pad_fixed_tail = scaffold.fixed_nodes[self.n :]

        # Banded operator scaffold: RCM-permute the node order so K is
        # narrow-banded, precompute the band scatter plan (fem/banded.py).
        # The permutation is internal — conditions are built on the
        # original mesh and results are unpermuted at fetch.
        self.band_hb = 0
        self._perm = None  # bucket-wide node permutation (None = identity)
        self._unperm = None
        coords_s, tris_s = scaffold.coords, scaffold.triangles
        if band_hb >= 0 and _use_banded() and self.dtype == jnp.float32:
            perm_r, hb_nat = rcm_permutation(mesh.triangles, self.n)
            hb = max(quantize_hb(hb_nat), band_hb)
            if hb <= min(self.node_bucket // 4, BAND_HB_CAP):
                perm = np.arange(self.node_bucket, dtype=np.int64)
                perm[: self.n] = perm_r
                inv = np.argsort(perm)
                self.band_hb = hb
                self._perm = perm
                self._unperm = inv
                coords_s = coords_s[perm]
                tris_s = inv[tris_s].astype(np.int64)
                # The band scatter plan is computed ON DEVICE from the
                # (already device-resident) triangle table at dispatch
                # (fem/banded.band_assembly_indices_dev; ghost padding
                # triangles are routed to node 0 there since their Ke is
                # exactly zero) instead of uploading a (36, Mb) plan per
                # solver.

        self._padded_triangles = tris_s
        incidence = build_incidence(
            tris_s,
            self.node_bucket,
            pad_degree=self._min_incidence_degree,
        )
        self.coords_dev = jnp.asarray(coords_s, self.dtype)
        self.triangles_dev = jnp.asarray(tris_s, jnp.int32)
        self.slots_dev = incidence.slots
        # Coarse rigid-body-mode space (condition-independent, per plate;
        # a pure function of node_bucket so grouped plates share shapes).
        self.n_coarse = n_coarse_for_bucket(self.node_bucket)
        # Recorded so dispatch_plate_group keys the kernel's blocked
        # coarse-apply path off what was actually BUILT (never off the
        # env alone — a build/dispatch disagreement would silently run
        # reshape row-sums over geometric aggregate tables).
        self.coarse_blocked = (
            _coarse_block()
            and self._perm is not None
            and self.node_bucket % self.n_coarse == 0
        )
        if self.coarse_blocked:
            # RCM order on device -> contiguous blocks are BFS level-set
            # neighborhoods; the flat kernel's coarse apply then runs
            # scatter/gather-free (coarse_apply_flat blocked path).
            space = build_block_aggregates(
                coords_s, self.n_coarse, n_real=self.n
            )
        else:
            space = build_aggregates(
                coords_s, self.n_coarse, n_real=self.n
            )
        self.agg_dev = jnp.asarray(space.agg_ids)
        self.arms_dev = jnp.asarray(space.arms, self.dtype)

    def build_problem(self, condition: Dict) -> StaticProblem:
        return StaticProblem.from_condition(
            self.mesh,
            material_regions=condition["material_regions"],
            point_constraints=condition["point_constraints"],
            edge_constraints=condition["edge_constraints"],
            point_forces=condition["point_forces"],
            edge_forces=condition["edge_forces"],
            num_steps=self.num_steps,
        )

    def dispatch(self, problem: StaticProblem):
        """Async dispatch; returns a device array (the packed result)."""
        young, poisson, free, loads = self._pad_condition_arrays(problem)
        return _solve_kernel_packed(
            self.coords_dev,
            self.triangles_dev,
            jnp.asarray(young, self.dtype),
            jnp.asarray(poisson, self.dtype),
            self.slots_dev,
            jnp.asarray(free, self.dtype),
            jnp.asarray(loads, self.dtype),
            self.agg_dev,
            self.arms_dev,
            tol=self.tol,
            max_iters=self.max_iters,
            accept_tol=self.accept_tol,
            restarts=self.restarts,
            include_cell_fields=self.include_cell_fields,
            n_coarse=self.n_coarse,
        )

    def fetch(self, token) -> SolveResult:
        packed = np.asarray(token)  # single round trip
        result = self._unpermute(
            unpack_solve(
                packed, self.node_bucket, self.tri_bucket, self.num_steps
            )
        )
        return result._replace(
            displacements=result.displacements[:, : self.n],
            strain=result.strain[:, : self.m],
            stress=result.stress[:, : self.m],
        )

    def _pad_condition_arrays(self, problem: StaticProblem):
        pad_m = self.tri_bucket - self.m
        young = np.concatenate([problem.young, np.zeros(pad_m)])
        poisson = np.concatenate([problem.poisson, np.zeros(pad_m)])
        free = ~np.concatenate([problem.fixed_nodes, self._pad_fixed_tail])
        loads = np.concatenate(
            [problem.loads, np.zeros((self.node_bucket - self.n, 2))]
        )
        if self._perm is not None:
            free = free[self._perm]
            loads = loads[self._perm]
        return young, poisson, free.astype(np.float32), loads

    def _unpermute(self, result: SolveResult) -> SolveResult:
        """Solver scaffold order -> original mesh node order."""
        if self._unperm is None:
            return result
        return result._replace(
            displacements=result.displacements[:, self._unperm]
        )

    def dispatch_batch(self, problems: List[StaticProblem]):
        """One dispatch for a batch of conditions on this plate's mesh."""
        arrays = [self._pad_condition_arrays(p) for p in problems]
        young_b = jnp.asarray(np.stack([a[0] for a in arrays]), self.dtype)
        poisson_b = jnp.asarray(np.stack([a[1] for a in arrays]), self.dtype)
        free_b = jnp.asarray(np.stack([a[2] for a in arrays]), self.dtype)
        loads_b = jnp.asarray(np.stack([a[3] for a in arrays]), self.dtype)
        return _solve_batch_kernel(
            self.coords_dev,
            self.triangles_dev,
            self.slots_dev,
            self.agg_dev,
            self.arms_dev,
            young_b,
            poisson_b,
            free_b,
            loads_b,
            tol=self.tol,
            max_iters=self.max_iters,
            accept_tol=self.accept_tol,
            restarts=self.restarts,
            include_cell_fields=self.include_cell_fields,
            n_coarse=self.n_coarse,
        )

    def fetch_batch(self, token) -> List[SolveResult]:
        packed_b = np.asarray(token)  # ONE round trip for the whole batch
        out = []
        for packed in packed_b:
            result = self._unpermute(
                unpack_solve(
                    packed, self.node_bucket, self.tri_bucket, self.num_steps
                )
            )
            out.append(
                result._replace(
                    displacements=result.displacements[:, : self.n],
                    strain=result.strain[:, : self.m],
                    stress=result.stress[:, : self.m],
                )
            )
        return out

    def failed_result(self) -> SolveResult:
        return _failed_result(self.num_steps, self.n, self.m)

    @property
    def shape_key(self):
        return (
            self.node_bucket,
            self.tri_bucket,
            int(self.slots_dev.shape[1]),
            self.band_hb,
        )


# Placement telemetry of the most recent sharded dispatch (plate-axis
# shard layout); written by dispatch_plate_group, asserted by
# parallel/scaling.py and the driver dryrun.
LAST_DISPATCH: Dict[str, int] = {}


def dispatch_plate_group(
    payloads,
    tol=None,
    max_iters: Optional[int] = None,
    sharding=None,
    pad_group_to: int = 0,
    x0s=None,
):
    """Async half of `solve_plate_group`: stack + upload a group of
    same-bucket plates, dispatch the two-level vmapped kernel, and return
    the device token immediately (the host is free to prep the next chunk
    while the solves run).

    `x0s`: optional list parallel to `payloads`; each entry is a list
    parallel to that payload's problems of per-condition warm starts
    ((N, 2) arrays in real-node coordinates) or None for a cold start."""
    n_real = len(payloads)
    if pad_group_to > n_real:
        payloads = payloads + [payloads[-1]] * (pad_group_to - n_real)
        if x0s is not None:
            x0s = list(x0s) + [x0s[-1]] * (pad_group_to - n_real)
    solver0 = payloads[0][0]
    for s, _ in payloads:
        assert s.shape_key[:3] == solver0.shape_key[:3]
    # banded requires a uniform half-bandwidth across the group (the
    # scheduler forces this via RunningBuckets.band); ad-hoc groups with
    # mixed hb fall back to the incidence operator
    band_hb = solver0.band_hb
    if any(s.band_hb != band_hb for s, _ in payloads):
        band_hb = 0

    coords_p = jnp.stack([s.coords_dev for s, _ in payloads])
    tris_p = jnp.stack([s.triangles_dev for s, _ in payloads])
    slots_p = jnp.stack([s.slots_dev for s, _ in payloads])
    agg_p = jnp.stack([s.agg_dev for s, _ in payloads])
    arms_p = jnp.stack([s.arms_dev for s, _ in payloads])

    young, poisson, free, loads, x0 = [], [], [], [], []
    for pi, (s, problems) in enumerate(payloads):
        arrays = [s._pad_condition_arrays(p) for p in problems]
        young.append(np.stack([a[0] for a in arrays]))
        poisson.append(np.stack([a[1] for a in arrays]))
        free.append(np.stack([a[2] for a in arrays]))
        loads.append(np.stack([a[3] for a in arrays]))
        x0_c = np.zeros((len(problems), s.node_bucket, 2), np.float32)
        if x0s is not None and x0s[pi] is not None:
            for ci, w in enumerate(x0s[pi]):
                if w is not None:
                    x0_c[ci, : s.n] = w
        if s._perm is not None:  # warm starts arrive in original order
            x0_c = x0_c[:, s._perm]
        x0.append(x0_c)
    dtype = solver0.dtype
    args = [
        coords_p,
        tris_p,
        slots_p,
        agg_p,
        arms_p,
        jnp.asarray(np.stack(young), dtype),
        jnp.asarray(np.stack(poisson), dtype),
        jnp.asarray(np.stack(free), dtype),
        jnp.asarray(np.stack(loads), dtype),
        jnp.asarray(np.stack(x0), dtype),
    ]
    if sharding is not None:
        args = [jax.device_put(a, sharding) for a in args]
        # telemetry for the dryrun/bench placement assertion: the plate
        # axis of THIS dispatch really landed one block per device
        shards = args[0].addressable_shards
        LAST_DISPATCH.clear()
        LAST_DISPATCH.update(
            n_devices=sharding.mesh.devices.size,
            n_shards=len(shards),
            rows=int(args[0].shape[0]),
            shard_rows=int(shards[0].data.shape[0]),
        )

    kw = dict(
        tol=solver0.tol if tol is None else tol,
        max_iters=solver0.max_iters if max_iters is None else max_iters,
        accept_tol=solver0.accept_tol,
        restarts=solver0.restarts,
        include_cell_fields=solver0.include_cell_fields,
        n_coarse=solver0.n_coarse,
    )
    if _use_flat_chunk():
        # The flat super-mesh kernel: the plate axis folds into the dof
        # axis so every CG-loop gather uses shared (unbatched) index
        # tables, where the batched-table two-level vmap gathers through
        # per-plate tables (see fem/flatgroup.py). With banded
        # solvers the CG operator additionally becomes a dense
        # block-shifted band matmul (fem/banded.py) — zero gathers in
        # the hot loop.
        #
        # Multi-device chunks wrap the SAME body in shard_map: each
        # device flattens and solves its own plates, so the program has
        # no cross-device collectives at all (plates are independent;
        # vmapping over a sharded plate axis would instead all-reduce
        # the CG while_loop condition every iteration — measured 0.52
        # scaling efficiency vs this layout's ~1.0).
        from ..fem.flatgroup import flat_group_body, solve_flat_group_kernel

        m_real_p = None
        kwf = dict(kw, coarse_fused=_coarse_fused())
        if band_hb > 0:
            m_real_p = jnp.asarray(
                [s.m for s, _ in payloads], dtype=jnp.int32
            )
            kwf = dict(
                kwf,
                band_block=_band_block(),
                # Keyed off the tables the solvers actually built, not
                # the env: mixing would run the reshape coarse apply
                # over geometric aggregates (silently wrong corrections)
                coarse_blocked=all(
                    getattr(s, "coarse_blocked", False)
                    for s, _ in payloads
                ),
            )
        if sharding is None:
            return solve_flat_group_kernel(
                *args, m_real_p=m_real_p, band_hb=band_hb, **kwf
            )
        mesh = sharding.mesh
        n_dev = mesh.devices.size
        if len(payloads) % n_dev == 0:
            spec = jax.sharding.PartitionSpec("dp")
            fn = _sharded_flat_kernel(
                mesh, band_hb, tuple(sorted(kwf.items()))
            )
            if m_real_p is not None:
                m_real_p = jax.device_put(
                    m_real_p, jax.sharding.NamedSharding(mesh, spec)
                )
                return fn(*args, m_real_p)
            return fn(*args)
    return _solve_multi_plate_kernel(*args, **kw)


@lru_cache(maxsize=32)
def _sharded_flat_kernel(mesh, band_hb: int, kw_items):
    """jitted shard_map of the flat chunk body over `mesh` (cached so
    repeat chunks reuse the compiled program instead of retracing)."""
    from ..fem.flatgroup import flat_group_body

    try:
        from jax import shard_map as _smap  # jax >= 0.6
    except ImportError:
        from jax.experimental.shard_map import shard_map as _smap

    kw = dict(kw_items)
    spec = jax.sharding.PartitionSpec("dp")
    n_args = 10 + (1 if band_hb > 0 else 0)

    def body(*a):
        if band_hb > 0:
            return flat_group_body(
                *a[:-1], m_real_p=a[-1], band_hb=band_hb, **kw
            )
        return flat_group_body(*a, band_hb=0, **kw)

    # replication/vma tracking trips over unvarying while_loop carries
    # (the iteration counter) in a body that is genuinely collective-free
    # — disable it (kwarg name varies across jax versions)
    try:
        mapped = _smap(
            body, mesh=mesh, in_specs=(spec,) * n_args, out_specs=spec,
            check_vma=False,
        )
    except TypeError:
        mapped = _smap(
            body, mesh=mesh, in_specs=(spec,) * n_args, out_specs=spec,
            check_rep=False,
        )
    return jax.jit(mapped)


def fetch_plate_group(token, payloads):
    """Blocking half of `solve_plate_group`: ONE round trip for the whole
    group, then unpack per plate/condition."""
    return unpack_plate_group(np.asarray(token), payloads)


def unpack_plate_group(packed, payloads):
    """Host-side unpack of an already-fetched packed group array."""
    out = []
    for (s, problems), packed_plate in zip(payloads, packed):
        results = []
        for packed_cond in packed_plate[: len(problems)]:
            r = s._unpermute(
                unpack_solve(
                    packed_cond, s.node_bucket, s.tri_bucket, s.num_steps
                )
            )
            results.append(
                r._replace(
                    displacements=r.displacements[:, : s.n],
                    strain=r.strain[:, : s.m],
                    stress=r.stress[:, : s.m],
                )
            )
        out.append(results)
    return out


def solve_plate_group(
    payloads,
    tol=None,
    max_iters: Optional[int] = None,
    sharding=None,
    pad_group_to: int = 0,
    x0s=None,
):
    """Solve all conditions of a group of same-bucket plates in ONE
    dispatch + ONE fetch.

    payloads: list of (PlateSolver, [StaticProblem, ...]) with equal
    shape_key and equal condition counts. Optional `sharding`: a
    jax.sharding.NamedSharding to distribute the plate axis over a device
    mesh. `pad_group_to` repeats the last payload so every group compiles
    at one fixed plate count. Returns list-of-lists of SolveResult
    matching the (unpadded) input."""
    token = dispatch_plate_group(
        payloads,
        tol=tol,
        max_iters=max_iters,
        sharding=sharding,
        pad_group_to=pad_group_to,
        x0s=x0s,
    )
    return fetch_plate_group(token, payloads)


class RunningBuckets:
    """Monotone bucket policy: every plate is padded up to the largest
    bucket seen so far in the run, so shapes (and compiled kernels, and
    grouped dispatches) stabilize after the first few plates instead of
    splintering into one shape key per plate. Scales with the actual mesh
    sizes — tiny test meshes stay tiny."""

    def __init__(self):
        self.node = 0
        self.tri = 0
        self.degree = 0
        self.band = 0
        # FEA_TPU_BUCKET_FLOOR="node,tri,degree,band" pre-ratchets the
        # buckets (e.g. to a previous run's final values, printed by the
        # hbm telemetry line) so a long run compiles its production
        # shapes once up front instead of recompiling mid-run while
        # earlier-shape chunks still hold device buffers — the
        # fragmentation spike suspected in the production OOMs.
        import os

        floor = os.environ.get("FEA_TPU_BUCKET_FLOOR")
        if floor:
            vals = [int(v) for v in floor.split(",")]
            self.node, self.tri, self.degree, self.band = vals

    def update(self, meshes) -> None:
        for mesh in meshes:
            self.node = max(self.node, next_bucket(mesh.num_nodes + 3))
            self.tri = max(self.tri, next_bucket(mesh.num_triangles))

    def update_degree(self, solvers) -> None:
        for s in solvers:
            self.degree = max(self.degree, int(s.slots_dev.shape[1]))
            self.band = max(self.band, s.band_hb)


# --- scheduler tuning (generate_data_batched) -------------------------------
# Per-dispatch PCG budget. The group kernel is LOCKSTEP: every lane pays
# for the slowest lane, so an unbounded chunk costs
# n_lanes x max_lane_iters while lane iterations are long-tailed (median
# ~100, p90 ~400, max 1500+) — ~3x the useful work. A small fixed budget
# makes every chunk cost n_lanes x K; lanes that need more CONTINUE in a
# later chunk warm-started from their partial x (each re-dispatch
# recomputes the true residual, acting as iterative refinement), so
# total device time approaches the sum of per-lane iterations (rounded
# up to K). Each extra dispatch costs one dispatch and one fetch.
# Continuation also
# keeps hard-but-valid conditions the reference's direct solver would
# have solved (fea_analysis.py:371-375) instead of resampling them.
ITERS_PER_DISPATCH = 300
RESTARTS_PER_DISPATCH = 1
MAX_CONTINUATIONS = 20
# lanes whose relative residual exceeds this are diverging, not slow —
# resample immediately instead of continuing
CONTINUE_RNORM_LIMIT = 1.0
# a continuing lane must beat its previous dispatch's residual by this
# factor, else it has hit its f32 floor and is resampled (host-side
# cross-dispatch stagnation detection)
CONTINUE_PROGRESS_FACTOR = 0.7


def _direct_fallback_enabled() -> bool:
    import os

    return os.environ.get("FEA_TPU_DIRECT_FALLBACK", "1") != "0"


# Terminal CG failures fall back to a host f64 SuperLU solve instead of
# resampling (the reference keeps every finite direct solve,
# fea_analysis.py:455-461 — see fem/direct.py). Opt out for A/Bs.
DIRECT_FALLBACK = _direct_fallback_enabled()


class _PlateJob:
    """One plate moving through the deferred-retry scheduler."""

    __slots__ = (
        "mesh", "solver", "pixel_map", "pairs", "results", "retries", "pool",
        "warm", "cont", "last_rnorm", "band_hint",
    )

    def __init__(self, mesh, pairs, pool):
        self.mesh = mesh
        self.band_hint: Optional[int] = None  # quantized NATURAL hb cache
        self.solver: Optional[PlateSolver] = None
        self.pixel_map = None
        self.pairs = pairs  # [(condition, problem)] per slot
        self.results = [None] * len(pairs)
        self.retries = 0
        self.pool = pool  # per-plate clustering cache for cheap resamples
        self.warm = [None] * len(pairs)  # per-slot PCG warm start (N,2)
        self.cont = [0] * len(pairs)  # per-slot continuation count
        self.last_rnorm = [None] * len(pairs)  # per-slot progress tracking

    def pending(self) -> List[int]:
        return [i for i, r in enumerate(self.results) if r is None]

    def complete(self) -> bool:
        return all(r is not None for r in self.results)


def generate_data_batched(
    data_dir: str = "data/",
    image_size: int = 512,
    num_plates: int = 8,
    start_plate: Optional[int] = None,
    conditions_per_plate: int = 4,
    mesh_size: float = 1e-2,
    num_polygons_range=(1, 3),
    points_per_polygon_range=(3, 8),
    holes_per_polygon_range=(0, 3),
    points_per_hole_range=(3, 4),
    num_regions=(1, 5),
    save_displacement: bool = True,
    save_strain: bool = False,
    save_stress: bool = False,
    num_steps_per_condition: int = 11,
    save_meshes: bool = False,
    seed=None,
    batch_size: int = 4,
    max_condition_retries: int = 30,
    n_devices: Optional[int] = None,
    wandb_inject_function=None,
    stage_timer=None,
    verbose: bool = True,
) -> Dict:
    """Multi-plate batched datagen (BASELINE config 3 — 'batched datagen').

    The throughput path. Built so that each device round trip carries as
    much work as possible:

      * a chunk of `batch_size` plates is padded to shared monotone
        running-max buckets so ALL of its solves run as ONE device program
        — one dispatch + ONE packed fetch per chunk;
      * failed (near-singular) conditions are NOT retried synchronously:
        the plate is re-queued and its resampled conditions ride the NEXT
        chunk's dispatch, so retries cost zero extra round trips (the
        reference pays a fresh SuperLU factorization to discover each NaN,
        fea_analysis.py:455-461);
      * host work (meshing, clustering, pixel maps, PNG writes) happens
        while solves are in flight.

    `batch_size` plates/dispatch defaults to 4: the group solve is one
    vmapped while_loop and every lane runs to the SLOWEST lane's finish, so
    big groups pay a lockstep tax.

    `n_devices` shards the plate axis of every dispatch over a ('dp',)
    jax.sharding.Mesh of that many devices (chunks are padded to a multiple
    of n_devices); each device solves its plates independently — devices
    exchange data only in the final gather of the packed results.
    """
    import os
    from timeit import default_timer as timer

    from ..geometry import GeometryError, GeometrySampler
    from ..mesh import MeshError, triangulate_polygon
    from ..raster import build_pixel_map, geometry_image, outline_image
    from ..utils.profiling import StageTimer
    from .conditions import ConditionSampler
    from .pipeline import _write_condition
    from .writers import save_gray_png, verify_directory

    verify_directory(data_dir)
    geometry_sampler = GeometrySampler(
        num_polygons_range=num_polygons_range,
        points_per_polygon_range=points_per_polygon_range,
        holes_per_polygon_range=holes_per_polygon_range,
        points_per_hole_range=points_per_hole_range,
        random_seed=seed,
    )
    condition_sampler = ConditionSampler(
        num_regions_range=num_regions,
        random_seed=None if seed is None else seed + 1,
    )
    include_cell_fields = save_strain or save_stress or save_meshes
    buckets = RunningBuckets()
    stages = stage_timer if stage_timer is not None else StageTimer()

    sharding = None
    group_size = batch_size
    if n_devices is not None and n_devices > 1:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import make_mesh

        dp_mesh = make_mesh(n_devices)
        sharding = NamedSharding(dp_mesh, PartitionSpec("dp"))
        # chunks must be a multiple of the device count
        group_size = max(batch_size, n_devices)
        group_size += (-group_size) % n_devices

    stats = {
        "plates": 0,
        # Device-side accounting (what the device actually ran):
        #   lane_dispatches  — every pending lane sent to the device,
        #                      including continuation re-dispatches
        #   solves           — unique condition attempts dispatched
        #                      (= lane_dispatches - continuations)
        #   failures         — dispatched attempts that failed CG
        #                      (= cg_failures)
        # Host-side accounting (never touched the device):
        #   host_rejections  — structurally-singular draws rejected by the
        #                      microsecond pre-check and resampled
        "lane_dispatches": 0,
        "solves": 0,
        "failures": 0,
        "host_rejections": 0,
        "singular_resamples": 0,  # alias of host_rejections (bench compat)
        "cg_failures": 0,
        # of the cg_failures: recovered by the host f64 SuperLU lane
        # (fem/direct.py) vs actually resampled. The reference resamples
        # only on a non-finite direct solve, so cg_resamples/solves is
        # the distribution-divergence rate vs the reference (target <2%).
        "direct_fallbacks": 0,
        "cg_resamples": 0,
        "continuations": 0,
        # (rnorm, iterations) of every failed CG lane — distinguishes
        # "stagnated just above accept_tol" (preconditioner/tolerance
        # problem) from "diverged/NaN" (genuinely near-singular draw).
        "failed_lanes": [],
        "converged_iters": [],
        "total_solve_time": 0.0,
        # union of [dispatch-issue, fetch-complete] intervals: the span the
        # device+link pipeline was occupied (chunks overlap under
        # multi-flight dispatch, so this is the honest busy time)
        "device_busy_s": 0.0,
    }
    run_start = timer()

    def fresh_pair(mesh, pool):
        """One non-structurally-singular (condition, problem), or None if
        the budget is blown. Cached clusterings make resamples cheap."""
        budget = max_condition_retries
        while True:
            condition = condition_sampler.sample_one(mesh, cluster_pool=pool)
            problem = StaticProblem.from_condition(
                mesh,
                material_regions=condition["material_regions"],
                point_constraints=condition["point_constraints"],
                edge_constraints=condition["edge_constraints"],
                point_forces=condition["point_forces"],
                edge_forces=condition["edge_forces"],
                num_steps=num_steps_per_condition,
            )
            if not problem.structurally_singular():
                return condition, problem
            stats["host_rejections"] += 1
            stats["singular_resamples"] += 1
            budget -= 1
            if budget <= 0:
                return None

    def prep_job() -> _PlateJob:
        """Host prep of one plate: geometry -> mesh -> C viable conditions."""
        while True:
            try:
                with stages.stage("geometry"):
                    polygon = geometry_sampler.generate()
                with stages.stage("mesh"):
                    mesh = triangulate_polygon(polygon, mesh_size=mesh_size)
            except (GeometryError, MeshError):
                continue
            pool: List = []
            with stages.stage("conditions"):
                try:
                    conditions = condition_sampler.sample(
                        mesh, conditions_per_plate, cluster_pool=pool
                    )
                except RuntimeError:
                    continue  # sampler did not converge: redraw plate
                pairs = []
                ok = True
                for condition in conditions:
                    problem = StaticProblem.from_condition(
                        mesh,
                        material_regions=condition["material_regions"],
                        point_constraints=condition["point_constraints"],
                        edge_constraints=condition["edge_constraints"],
                        point_forces=condition["point_forces"],
                        edge_forces=condition["edge_forces"],
                        num_steps=num_steps_per_condition,
                    )
                    if problem.structurally_singular():
                        stats["host_rejections"] += 1
                        stats["singular_resamples"] += 1
                        pair = fresh_pair(mesh, pool)
                        if pair is None:
                            ok = False
                            break
                        pairs.append(pair)
                    else:
                        pairs.append((condition, problem))
            if ok:
                return _PlateJob(mesh, pairs, pool)

    def band_class(job: _PlateJob) -> int:
        """Effective banded half-bandwidth the job's solver WILL get at
        the current buckets (0 = incidence operator). Must mirror
        PlateSolver's own criterion exactly — hb = max(natural,
        buckets.band) and hb <= min(node_bucket // 4, BAND_HB_CAP) —
        otherwise a 'banded-class' job can build a band_hb=0 solver and
        the mixed-chunk safety net (buckets.band = -1) permanently
        disables banding for the run. Only the quantized natural hb is
        cached; the bucket-dependent classification is recomputed per
        call (buckets grow during a run)."""
        if job.band_hint is None:
            if not _use_banded():
                job.band_hint = 0
            else:
                _, hb_nat = rcm_permutation(
                    np.asarray(job.mesh.triangles), job.mesh.num_nodes
                )
                job.band_hint = quantize_hb(hb_nat)
        hb = job.band_hint
        if hb <= 0:
            return 0
        eff = max(hb, max(buckets.band, 0))
        return eff if eff <= min(buckets.node // 4, BAND_HB_CAP) else 0

    def ensure_solver(job: _PlateJob, want_band: Optional[bool] = None) -> None:
        """(Re)build the job's solver at the CURRENT running buckets, so
        every payload of a dispatch shares one shape key (one compiled
        kernel, one fetch). `want_band` pins the chunk's band class:
        dispatch_chunk groups jobs by class BEFORE buckets.update can
        grow buckets.node (which loosens band_class), so re-deriving the
        class here could band one job of an incidence chunk and trip the
        mixed-chunk fallback."""
        key = (buckets.node, buckets.tri)
        if want_band is None:
            want_band = buckets.band >= 0 and band_class(job) > 0
        if (
            job.solver is not None
            and job.solver.node_bucket == key[0]
            and job.solver.tri_bucket == key[1]
            and job.solver.slots_dev.shape[1] >= buckets.degree
            and (job.solver.band_hb > 0) == want_band
            and (not want_band or job.solver.band_hb >= buckets.band)
        ):
            return
        with stages.stage("solver_build"):
            job.solver = PlateSolver(
                job.mesh,
                num_steps_per_condition,
                node_bucket=buckets.node,
                tri_bucket=buckets.tri,
                min_incidence_degree=buckets.degree,
                band_hb=buckets.band if want_band else -1,
                include_cell_fields=include_cell_fields,
                max_iters=ITERS_PER_DISPATCH,
                restarts=RESTARTS_PER_DISPATCH,
            )
            # NB: band_hint deliberately NOT updated from solver.band_hb —
            # the hint caches the quantized NATURAL half-bandwidth, while
            # solver.band_hb is the effective one (forced-min raised, or 0
            # when built unbanded); mixing them corrupts band_class

    def write_job(job: _PlateJob, plate_number: int) -> None:
        with stages.stage("pixel_map"):
            if job.pixel_map is None:
                job.pixel_map = build_pixel_map(
                    job.mesh.coords,
                    job.mesh.triangles,
                    image_size,
                    pad_candidates=32,
                    pad_shapes=(buckets.node, buckets.tri),
                )
        with stages.stage("write"):
            plate_dir = os.path.join(data_dir, str(plate_number))
            verify_directory(plate_dir)
            for slot, ((condition, _), result) in enumerate(
                zip(job.pairs, job.results)
            ):
                condition_dir = os.path.join(plate_dir, str(slot + 1))
                verify_directory(condition_dir)
                _write_condition(
                    job.mesh,
                    job.pixel_map,
                    condition,
                    result,
                    condition_dir,
                    num_steps_per_condition,
                    save_displacement,
                    save_strain,
                    save_stress,
                    save_meshes,
                )
            # plate-level images LAST, input.png atomically: a plate dir
            # containing input.png is guaranteed complete, so killed runs
            # (OOM, watchdog, bench pause) can resume by counting plates
            # with the sentinel and deleting partial dirs
            save_gray_png(
                os.path.join(plate_dir, "outline.png"),
                outline_image(
                    job.pixel_map, job.mesh.coords, job.mesh.ring_corner_ids
                ),
            )
            tmp_input = os.path.join(plate_dir, ".input.tmp.png")
            save_gray_png(tmp_input, geometry_image(job.pixel_map))
            os.replace(tmp_input, os.path.join(plate_dir, "input.png"))

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    from concurrent.futures import TimeoutError as FutureTimeout

    ready: deque = deque()  # jobs with pending solves
    writes: deque = deque()  # completed jobs awaiting disk writes
    flights: deque = deque()  # dispatched chunks: (t0, future, payloads, jobs, pendings)
    plate_seq = (start_plate - 1) if start_plate is not None else 0
    written = 0
    # Three chunks in the pipeline: one executing, one queued on the
    # device, one absorbing dispatch jitter. The blocking np.asarray
    # conversion runs on a fetch thread (the device wait releases the
    # GIL), so the scheduler preps and writes while results land.
    MAX_FLIGHTS = int(os.environ.get("FEA_TPU_MAX_FLIGHTS", "3"))
    PREP_AHEAD = 2  # ready may hold up to PREP_AHEAD x group_size jobs
    # one worker per flight, so fetches overlap
    fetcher = ThreadPoolExecutor(max_workers=MAX_FLIGHTS)
    busy_intervals: List = []  # (dispatch-issue, fetch-complete) per chunk

    def _fetch_task(token):
        # Wait for execution, then convert: the completion time is the
        # end of this chunk's busy interval.
        token.block_until_ready()
        return np.asarray(token), timer()

    def in_system() -> int:
        return (
            len(ready)
            + len(writes)
            + sum(len(jobs) for _, _, _, jobs, _ in flights)
        )

    def can_prep() -> bool:
        return (
            in_system() + written < num_plates
            and len(ready) < PREP_AHEAD * group_size
        )

    def dispatch_chunk():
        """Assemble one chunk from `ready` and dispatch it (async); the
        packed-result conversion is handed to the fetch thread."""
        # one chunk = one band class: a capped (hb > BAND_HB_CAP) plate
        # rides a dedicated incidence-operator chunk instead of forcing
        # banding off (or the band buffer up) for everyone else
        want = band_class(ready[0]) > 0
        jobs, skipped = [], []
        while ready and len(jobs) < group_size:
            j = ready.popleft()
            if (band_class(j) > 0) == want:
                jobs.append(j)
            else:
                skipped.append(j)
        for j in reversed(skipped):
            ready.appendleft(j)  # other class dispatches next
        chunk_band = want and buckets.band >= 0
        buckets.update(j.mesh for j in jobs)
        for job in jobs:
            ensure_solver(job, want_band=chunk_band)
        wmax = max(j.solver.slots_dev.shape[1] for j in jobs)
        if wmax > buckets.degree:
            buckets.degree = wmax
            for job in jobs:
                ensure_solver(job, want_band=chunk_band)  # rebuild narrower
        hbs = [j.solver.band_hb for j in jobs]
        if buckets.band >= 0:
            if 0 in hbs and max(hbs) > 0:
                # mixed chunk should be impossible now (class grouping);
                # keep the monotone run-wide fallback as a safety net
                buckets.band = -1
                chunk_band = False
                for job in jobs:
                    ensure_solver(job, want_band=False)
            elif max(hbs) > buckets.band:
                buckets.band = max(hbs)
                for job in jobs:
                    ensure_solver(job, want_band=chunk_band)  # widen bands
        payloads = []
        pendings = []
        x0s = []
        for job in jobs:
            idx = job.pending()
            probs = [job.pairs[i][1] for i in idx]
            warms = [job.warm[i] for i in idx]
            while len(probs) < conditions_per_plate:  # pad retry lanes
                probs.append(probs[-1])
                warms.append(warms[-1])
            payloads.append((job.solver, probs))
            pendings.append(idx)
            x0s.append(warms)
        with stages.stage("dispatch"):
            t0 = timer()
            token = dispatch_plate_group(
                payloads, sharding=sharding, pad_group_to=group_size, x0s=x0s
            )
            # Stage the D2H transfer as soon as the solve finishes (it
            # queues behind the compute), so the fetch thread's blocking
            # np.asarray finds the bytes already on host instead of
            # paying compute + transfer serially.
            token.copy_to_host_async()
            future = fetcher.submit(_fetch_task, token)
        stats["lane_dispatches"] += sum(len(i) for i in pendings)
        flights.append((t0, future, payloads, jobs, pendings))
        # Device-memory telemetry: log the allocator curve so growth or
        # fragmentation in long runs is attributable from the run log
        # (every 10 chunks).
        stats["chunks"] = stats.get("chunks", 0) + 1
        if verbose and stats["chunks"] % 10 == 1:
            try:
                ms = jax.local_devices()[0].memory_stats() or {}
                print(
                    f"device memory: in_use={ms.get('bytes_in_use', -1) / 1e9:.2f}GB "
                    f"peak={ms.get('peak_bytes_in_use', -1) / 1e9:.2f}GB "
                    f"limit={ms.get('bytes_limit', -1) / 1e9:.2f}GB "
                    f"(chunk {stats['chunks']}, band={buckets.band}, "
                    f"node={buckets.node})",
                    flush=True,
                )
            except Exception:
                pass

    def drain_writes(limit: Optional[int] = None):
        nonlocal plate_seq, written
        while writes and (limit is None or limit > 0):
            job = writes.popleft()
            plate_seq += 1
            write_job(job, plate_seq)
            written += 1
            stats["plates"] += 1
            if limit is not None:
                limit -= 1
            if wandb_inject_function is not None:
                elapsed = timer() - run_start
                remaining = (
                    (num_plates - written) * elapsed / max(written, 1)
                )
                wandb_inject_function(plate_seq - 1, elapsed, remaining)
            if verbose:
                rate = written / max(timer() - run_start, 1e-9) * 3600
                print(
                    f"plate {plate_seq} written "
                    f"({written}/{num_plates}, {rate:.0f} plates/h)"
                )

    def overlap_until_ready(future) -> None:
        """Host work (prep, pixel maps, writes) until `future` completes;
        only the truly idle remainder is charged to the fetch stage."""
        while not future.done():
            if can_prep():
                with stages.stage("overlap_host"):
                    ready.append(prep_job())
                continue
            did = False
            for _, _, _, jobs, _ in flights:
                for job in jobs:  # pixel maps for dispatched plates
                    if job.pixel_map is None:
                        with stages.stage("pixel_map"):
                            job.pixel_map = build_pixel_map(
                                job.mesh.coords,
                                job.mesh.triangles,
                                image_size,
                                pad_candidates=32,
                                pad_shapes=(buckets.node, buckets.tri),
                            )
                        did = True
                        break
                if did:
                    break
            if did:
                continue
            if writes:
                with stages.stage("overlap_host"):
                    drain_writes(limit=1)
                continue
            with stages.stage("fetch"):
                try:
                    future.result(timeout=0.05)
                except FutureTimeout:
                    pass

    # Pipeline fill: prep the first chunk (nothing to overlap with yet).
    while in_system() + written < num_plates and len(ready) < group_size:
        ready.append(prep_job())

    while written < num_plates:
        # ---- keep up to MAX_FLIGHTS chunks queued on the device ----------
        while len(flights) < MAX_FLIGHTS:
            # top the queue up first so retries merge into full chunks and
            # the prep work overlaps any solves already in flight
            with stages.stage("overlap_host"):
                while (
                    in_system() + written < num_plates
                    and len(ready) < group_size
                ):
                    ready.append(prep_job())
            if not ready:
                break
            dispatch_chunk()

        if not flights:
            # nothing in flight: flush writes, refill for the next lap
            with stages.stage("overlap_host"):
                drain_writes()
                while in_system() + written < num_plates and len(ready) < group_size:
                    ready.append(prep_job())
            if not ready and not writes and in_system() == 0 and written < num_plates:
                continue  # replacement plates for abandoned ones
            if not ready:
                continue
            dispatch_chunk()

        # ---- overlap the oldest in-flight chunk with host work -----------
        t0, future, payloads, jobs, pendings = flights[0]
        overlap_until_ready(future)
        flights.popleft()
        with stages.stage("fetch"):
            packed, t_done = future.result()
        solved = unpack_plate_group(packed, payloads)
        stats["total_solve_time"] += t_done - t0
        busy_intervals.append((t0, t_done))

        for job, idx, results in zip(jobs, pendings, solved):
            for slot, result in zip(idx, results):
                if result.success:
                    job.results[slot] = result
                    job.warm[slot] = None
                    job.last_rnorm[slot] = None
                    stats["converged_iters"].append(int(result.iterations))
                    continue
                rnorm = float(result.residual_norm)
                prev = job.last_rnorm[slot]
                if (
                    np.isfinite(rnorm)
                    and rnorm < CONTINUE_RNORM_LIMIT
                    and job.cont[slot] < MAX_CONTINUATIONS
                    and (prev is None or rnorm < CONTINUE_PROGRESS_FACTOR * prev)
                ):
                    # slow, not singular: continue in a later chunk from
                    # the partial solution (u(1) = displacements[-1] = x)
                    job.cont[slot] += 1
                    job.warm[slot] = np.asarray(
                        result.displacements[-1], np.float32
                    )
                    job.last_rnorm[slot] = rnorm
                    stats["continuations"] += 1
                    continue
                stats["failures"] += 1
                stats["cg_failures"] += 1
                stats["failed_lanes"].append(
                    (rnorm, int(result.iterations))
                )
                job.warm[slot] = None
                job.cont[slot] = 0
                job.last_rnorm[slot] = None
                # Terminal CG failure: before resampling, try the host
                # f64 SuperLU lane — the reference keeps every finite
                # direct solve (fea_analysis.py:455-461), so resampling
                # here would thin the ill-conditioned tail of the data
                # distribution (measured ~10% of oracle-solvable
                # conditions, docs/screen_oracle.json). <1 s on host,
                # overlapped with chunks already in flight.
                if DIRECT_FALLBACK:
                    with stages.stage("direct_fallback"):
                        direct = direct_solve(job.pairs[slot][1])
                    if direct is not None:
                        job.results[slot] = direct
                        stats["direct_fallbacks"] += 1
                        continue
                stats["cg_resamples"] += 1
                job.retries += 1
                with stages.stage("conditions"):
                    pair = (
                        fresh_pair(job.mesh, job.pool)
                        if job.retries <= max_condition_retries
                        else None
                    )
                if pair is None:
                    job.retries = -1  # abandon marker
                    break
                job.pairs[slot] = pair
            if job.retries < 0:
                if verbose:
                    print("abandoning unsatisfiable plate")
                continue  # dropped; queue refill preps a replacement
            if job.complete():
                writes.append(job)
            else:
                ready.append(job)  # retry rides a later chunk

        # Nothing in flight or ready: drain writes, then refill.
        if not ready and not flights:
            drain_writes()
            while in_system() + written < num_plates and len(ready) < group_size:
                ready.append(prep_job())

    fetcher.shutdown(wait=True)
    # derived device-honest counters (see stats docstring above)
    stats["solves"] = stats["lane_dispatches"] - stats["continuations"]
    stats["failures"] = stats["cg_failures"]
    busy = 0.0
    end = None
    for s, e in sorted(busy_intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    stats["device_busy_s"] = busy
    stats["final_buckets"] = (
        buckets.node, buckets.tri, buckets.degree, buckets.band
    )
    if verbose:
        print("TOTAL TIME:", timer() - run_start)
        print(
            "final buckets (FEA_TPU_BUCKET_FLOOR):",
            ",".join(str(v) for v in stats["final_buckets"]),
        )
        print(stages.summary())
    stats["stage_seconds"] = stages.as_dict()
    return stats
