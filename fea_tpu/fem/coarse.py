"""Two-level aggregation preconditioner for the batched elasticity PCG.

The reference solves every system with a sparse direct LU
(fea_analysis.py:371-375), which is immune to conditioning. Our matrix-free
f32 CG is not: random plates with thin features, point loads, and
zero-stiffness straddling cells (the sfepy region semantics) reach
condition numbers where block-Jacobi PCG stalls near 1e-3 relative
residual after thousands of lockstep iterations — each stall burning a
whole vmapped plate-group's device time and biasing datagen by resampling
hard-but-valid conditions.

Fix: a coarse space of per-aggregate rigid-body modes (the 2D elasticity
near-null space: x/y translation + rotation), solved DENSELY.

  M^-1 = block-Jacobi  +  P (P^T K P)^-1 P^T      (additive two-level)

  * aggregates: geometric node binning on a uniform grid (host, O(N));
  * P: 3 modes per aggregate, masked at Dirichlet dofs (device);
  * Kc = P^T K P assembled from the element 6x6 blocks by scatter-add
    (device, once per condition — K depends on condition materials/BCs);
  * Kc^-1 formed explicitly via Cholesky so each CG iteration's coarse
    correction is ONE dense (3Nc,3Nc)x(3Nc) matmul, with no triangular
    solves in the hot loop.

Everything is static-shape: n_coarse is a pure function of the node
bucket, so bucketed plates share one compiled kernel.
"""

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGH = jax.lax.Precision.HIGHEST


class CoarseSpace(NamedTuple):
    """Host-built per-plate aggregation (condition-independent).

    agg_ids: (N,) int32 aggregate of each node (padding ghosts -> outlier
             aggregate with zero arm; they are Dirichlet-fixed and masked).
    arms:    (N, 2) float32 node offset from its aggregate centroid (the
             rotation-mode moment arm).
    n_coarse: static aggregate count (grid cells + 1 outlier slot).
    """

    agg_ids: np.ndarray
    arms: np.ndarray
    n_coarse: int


def n_coarse_for_bucket(node_bucket: int, agg_target: int = 16) -> int:
    """Static coarse size for a node bucket: ~one aggregate per
    `agg_target` nodes, floor 8, cap 1024. Shared by all plates in the
    bucket. The cap bounds the dense coarse operator: Kc and its inverse
    are (3*n_coarse)^2 floats per vmapped lane and the factorization is
    O((3*n_coarse)^3) — uncapped, the upper SHAPE_BUCKETS would OOM HBM
    (node_bucket 131072 -> nc 8192 -> ~2.4 GB of Kc per lane). 1024
    aggregates capture the low-frequency modes of any mesh this pipeline
    produces; beyond that the coarse grid stops paying for itself."""
    return min(max(node_bucket // agg_target, 8), 1024)


def build_aggregates(
    coords: np.ndarray,
    n_coarse: int,
    n_real: Optional[int] = None,
) -> CoarseSpace:
    """Geometric aggregation: bin the real nodes on a uniform grid over
    their bbox sized so used cells < n_coarse; compact to dense ids.

    Nodes beyond `n_real` (bucket-padding ghosts, placed far from the
    domain by StaticProblem.padded) go to a reserved outlier aggregate
    with zero arm — they are always Dirichlet-fixed, so they contribute
    nothing to P^T K P or to the coarse residual."""
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    if n_real is None:
        n_real = n
    real = coords[:n_real]
    # grid_n^2 <= n_coarse - 1 (one slot reserved for the outlier agg)
    grid_n = max(int(np.floor(np.sqrt(max(n_coarse - 1, 1)))), 1)
    lo = real.min(axis=0)
    hi = real.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    cell = np.clip(
        ((real - lo) / span * grid_n).astype(np.int64), 0, grid_n - 1
    )
    flat = cell[:, 0] * grid_n + cell[:, 1]
    used, compact = np.unique(flat, return_inverse=True)
    n_used = len(used)
    assert n_used < n_coarse, (n_used, n_coarse)

    agg_ids = np.full(n, n_coarse - 1, dtype=np.int32)  # outlier default
    agg_ids[:n_real] = compact.astype(np.int32)

    # centroids of the real aggregates -> rotation arms
    sums = np.zeros((n_used, 2))
    np.add.at(sums, compact, real)
    counts = np.bincount(compact, minlength=n_used).astype(np.float64)
    centroids = sums / counts[:, None]
    arms = np.zeros((n, 2), dtype=np.float32)
    arms[:n_real] = (real - centroids[compact]).astype(np.float32)
    return CoarseSpace(agg_ids=agg_ids, arms=arms, n_coarse=n_coarse)


def build_block_aggregates(
    coords: np.ndarray,
    n_coarse: int,
    n_real: Optional[int] = None,
) -> CoarseSpace:
    """Aggregate = contiguous block of the CURRENT node order.

    Built for the RCM-permuted banded path: consecutive RCM nodes are
    BFS level-set neighbors, so fixed-size blocks are spatially coherent
    aggregates — and because they are contiguous and equal-sized, the
    CG hot loop's restriction/prolongation become pure reshapes +
    row-sums/broadcasts with ZERO segment/gather ops (the 48%/iteration
    cost measured by benchmarks/iteration_profile.py; see
    coarse_apply_flat's `blocked` path). Requires len(coords) % n_coarse
    == 0 — true for every SHAPE_BUCKETS/n_coarse_for_bucket pair.

    Ghost padding nodes (beyond `n_real`) fall into the tail blocks;
    they get zero arms and are excluded from block centroids so they
    cannot poison a straddling block's rotation mode (they are always
    Dirichlet-fixed, so they contribute nothing to Kc or the residual)."""
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    if n_real is None:
        n_real = n
    assert n % n_coarse == 0, (n, n_coarse)
    B = n // n_coarse
    agg_ids = (np.arange(n, dtype=np.int32) // B).astype(np.int32)
    real = np.zeros(n, bool)
    real[:n_real] = True
    w = real.astype(np.float64)
    counts = w.reshape(n_coarse, B).sum(axis=1)  # real members per block
    sums = (coords * w[:, None]).reshape(n_coarse, B, 2).sum(axis=1)
    centroids = sums / np.maximum(counts, 1.0)[:, None]
    arms = np.zeros((n, 2), dtype=np.float32)
    arms[:n_real] = (
        coords[:n_real] - np.repeat(centroids, B, axis=0)[:n_real]
    ).astype(np.float32)
    return CoarseSpace(agg_ids=agg_ids, arms=arms, n_coarse=n_coarse)


def build_coarse_matrix(
    Ke: jnp.ndarray,  # (6,6,M) element-minor, dof order (x0,y0,x1,y1,x2,y2)
    triangles: jnp.ndarray,  # (M,3)
    agg_ids: jnp.ndarray,  # (N,)
    arms: jnp.ndarray,  # (N,2)
    free_nodes: jnp.ndarray,  # (N,) 1.0 free / 0.0 fixed
    n_coarse: int,
) -> jnp.ndarray:
    """Kc = P^T K P assembled element-wise: each element's 6x6 block maps
    to the <=9 coarse dofs (3 vertex aggregates x 3 rigid modes) through
    the local prolongation Le, then scatter-adds into the dense Kc.

    Returns (3*n_coarse, 3*n_coarse), SPD-regularized (unit diagonal on
    empty aggregates, small ridge elsewhere) and Cholesky-ready."""
    dtype = Ke.dtype
    tri = triangles  # (M,3)
    arm_e = arms[tri].astype(dtype)  # (M,3,2)
    free_e = free_nodes[tri].astype(dtype)  # (M,3)

    # Le[k, 3s+m] for k = 2a+c, nonzero iff s == a:
    #   c=0: (1, 0, -arm_y) ; c=1: (0, 1, +arm_x)   x free(node)
    M = tri.shape[0]
    Le = jnp.zeros((6, 9, M), dtype)
    for a in range(3):
        f = free_e[:, a]
        Le = Le.at[2 * a + 0, 3 * a + 0].set(f)
        Le = Le.at[2 * a + 0, 3 * a + 2].set(-arm_e[:, a, 1] * f)
        Le = Le.at[2 * a + 1, 3 * a + 1].set(f)
        Le = Le.at[2 * a + 1, 3 * a + 2].set(arm_e[:, a, 0] * f)

    # Kce = Le^T Ke Le, element-minor throughout
    T1 = jnp.einsum("klm,ljm->kjm", Ke, Le, precision=_HIGH)  # (6,9,M)
    Kce = jnp.einsum("kim,kjm->ijm", Le, T1, precision=_HIGH)  # (9,9,M)

    # coarse dof of local slot (s, m): 3*agg[tri[:, s]] + m
    cdof = (3 * agg_ids[tri]).T  # (3, M)
    cdof = jnp.concatenate(
        [cdof[s][None].repeat(3, 0) + jnp.arange(3)[:, None] for s in range(3)]
    )  # (9, M)
    nc3 = 3 * n_coarse
    flat = (cdof[:, None, :] * nc3 + cdof[None, :, :]).reshape(-1)  # (81*M,)
    Kc = (
        jnp.zeros((nc3 * nc3,), dtype)
        .at[flat]
        .add(Kce.reshape(-1))
        .reshape(nc3, nc3)
    )

    # Regularize: empty aggregates (no free node) get an identity diagonal;
    # the rest a tiny ridge so f32 Cholesky stays positive.
    d = jnp.diagonal(Kc)
    ridge = 1e-6 * jnp.max(d) + jnp.where(d <= 0.0, 1.0, 0.0)
    return Kc + jnp.diag(ridge)


def coarse_inverse(Kc: jnp.ndarray) -> jnp.ndarray:
    """Explicit Kc^-1 via Cholesky (one-time); NaN-safe: a
    failed factorization (pathological lane) degrades to the zero matrix,
    i.e. plain block-Jacobi for that lane."""
    nc3 = Kc.shape[0]
    L = jnp.linalg.cholesky(Kc)
    eye = jnp.eye(nc3, dtype=Kc.dtype)
    inv = jax.scipy.linalg.cho_solve((L, True), eye)
    ok = jnp.all(jnp.isfinite(inv))
    return jnp.where(ok, inv, jnp.zeros_like(inv))


def coarse_apply(
    Kc_inv: jnp.ndarray,  # (3Nc, 3Nc)
    agg_ids: jnp.ndarray,  # (N,)
    arms: jnp.ndarray,  # (N,2)
    r_planar: jnp.ndarray,  # (2N,) comp-major (x block then y block)
    n_coarse: int,
) -> jnp.ndarray:
    """z = P Kc^-1 P^T r on planar dof vectors (the CG hot-loop term).

    Restriction = 3 segment-sums; coarse solve = one dense matvec;
    prolongation = gathers. r is already masked at fixed dofs by the CG
    loop, and P's fixed rows are zero in Kc, so no extra masking needed."""
    n = agg_ids.shape[0]
    dtype = r_planar.dtype
    rx = r_planar[:n]
    ry = r_planar[n:]
    armx = arms[:, 0].astype(dtype)
    army = arms[:, 1].astype(dtype)
    s0 = jax.ops.segment_sum(rx, agg_ids, num_segments=n_coarse)
    s1 = jax.ops.segment_sum(ry, agg_ids, num_segments=n_coarse)
    s2 = jax.ops.segment_sum(
        -army * rx + armx * ry, agg_ids, num_segments=n_coarse
    )
    rc = jnp.stack([s0, s1, s2], axis=1).reshape(-1)  # (3Nc,) [3a+m]
    # precision pin: an unpinned f32 matvec may run at reduced precision
    # (TF32 on GPUs), making the coarse correction vary per iteration —
    # a nonsymmetric, iteration-varying preconditioner that
    # voids PCG's convergence guarantee exactly on the ill-conditioned
    # lanes the coarse space exists for (flatgroup.py:164 pins its twin)
    zc = jnp.matmul(Kc_inv, rc, precision=_HIGH)
    zc3 = zc.reshape(n_coarse, 3)
    tx = zc3[agg_ids, 0]
    ty = zc3[agg_ids, 1]
    rot = zc3[agg_ids, 2]
    zx = tx - army * rot
    zy = ty + armx * rot
    return jnp.concatenate([zx, zy])
