"""Flat (super-mesh) plate-group solve: the single-device chunk kernel.

A chunk of P same-bucket plates x C conditions used to run as a two-level
vmap (plates x conditions) of the single-mesh solve. That lowers the hot
gathers (element-dof gather + incidence gather-sum) with BATCHED index
tables, and it forces the coarse preconditioner's segment ops through
batched-index scatters too.

Here the P plates are concatenated into ONE disconnected super-mesh
inside the kernel (pure elementwise offsets of the per-plate tables the
solvers already hold on device, so the host uploads nothing new):

  * node axis: plate p's nodes live at [p*Nb, (p+1)*Nb); planar dofs keep
    the component-major layout (x block then y block) over all P*Nb nodes;
  * element axis: plate p's triangles live at [p*Mb, (p+1)*Mb);
  * the vmap runs over CONDITIONS only; every gather/scatter in the CG
    hot loop uses the flat shared tables (no batch dims);
  * CG runs SEGMENTED: alpha/beta/convergence are per-plate scalars
    computed by reshape-reductions (plates are contiguous), which is
    mathematically identical to independent CG per plate because the
    super-system is block-diagonal (see solver.pcg_solve_segmented);
  * the coarse preconditioner becomes P batched dense (3nc, 3nc) solves
    with flat segment sums over a shared aggregate-id table.

Replaces the reference's per-condition SuperLU factorizations
(datagen/fea_analysis.py:418-461) as the datagen throughput core.
"""

from functools import partial

import jax
import jax.numpy as jnp

from .assembly import apply_element_stiffness_planar, element_dof_indices
from .banded import (
    assemble_band,
    band_assembly_indices_dev,
    band_block_diagonal,
    banded_matvec,
    gram_apply,
    interleaved_to_planar,
    planar_to_interleaved,
    spd_block_inv_factor,
    window_index,
)
from .coarse import coarse_inverse
from .elasticity import element_stiffness, plane_strain_stiffness_em
from .solver import (
    block_diagonal,
    extract_diagonal,
    invert_blocks,
    pcg_solve_segmented,
)

_HIGH = jax.lax.Precision.HIGHEST


def flatten_tables(coords_p, triangles_p, slots_p, agg_p, arms_p, n_coarse):
    """Batched per-plate tables -> flat super-mesh tables (device-side,
    elementwise; negligible next to one CG iteration).

    slots values are per-plate k*Mb + e (k in [0,6), sentinel 6*Mb) into
    the plate's (6*Mb+1,) fe vector; flat values are k*(P*Mb) + p*Mb + e
    with the single shared sentinel 6*P*Mb."""
    P, Nb, _ = coords_p.shape
    Mb = triangles_p.shape[1]
    p_ids = jnp.arange(P, dtype=jnp.int32)

    coords = coords_p.reshape(P * Nb, 2)
    tris = (triangles_p + (p_ids * Nb)[:, None, None]).reshape(P * Mb, 3)
    v = slots_p  # (P, 2*Nb, W)
    k, e = jnp.divmod(v, Mb)
    flat = k * (P * Mb) + p_ids[:, None, None] * Mb + e
    slots = jnp.where(v == 6 * Mb, 6 * P * Mb, flat)
    # rows of slots_p are per-plate planar (comp*Nb + n); flat planar rows
    # are comp*(P*Nb) + p*Nb + n -> regroup the component axis outermost
    slots = (
        slots.reshape(P, 2, Nb, -1)
        .transpose(1, 0, 2, 3)
        .reshape(2 * P * Nb, -1)
    )
    agg = (agg_p + (p_ids * n_coarse)[:, None]).reshape(P * Nb)
    arms = arms_p.reshape(P * Nb, 2)
    return coords, tris, slots, agg, arms


def build_coarse_matrix_flat(
    Ke: jnp.ndarray,  # (6,6,P*Mb) element-minor
    triangles: jnp.ndarray,  # (P*Mb,3) flat node ids
    agg_ids: jnp.ndarray,  # (P*Nb,) flat (p*nc + local)
    arms: jnp.ndarray,  # (P*Nb,2)
    free_nodes: jnp.ndarray,  # (P*Nb,) 1.0 free / 0.0 fixed
    P: int,
    n_coarse: int,
) -> jnp.ndarray:
    """Per-plate Kc = P^T K P, returned batched (P, 3nc, 3nc).

    Same element-wise assembly as coarse.build_coarse_matrix, but the
    scatter indices are flat shared tensors: element e belongs to plate
    e // Mb and its 9x9 coarse block lands in that plate's dense Kc."""
    dtype = Ke.dtype
    tri = triangles
    PM = tri.shape[0]
    Mb = PM // P
    arm_e = arms[tri].astype(dtype)  # (PM,3,2)
    free_e = free_nodes[tri].astype(dtype)  # (PM,3)

    Le = jnp.zeros((6, 9, PM), dtype)
    for a in range(3):
        f = free_e[:, a]
        Le = Le.at[2 * a + 0, 3 * a + 0].set(f)
        Le = Le.at[2 * a + 0, 3 * a + 2].set(-arm_e[:, a, 1] * f)
        Le = Le.at[2 * a + 1, 3 * a + 1].set(f)
        Le = Le.at[2 * a + 1, 3 * a + 2].set(arm_e[:, a, 0] * f)

    T1 = jnp.einsum("klm,ljm->kjm", Ke, Le, precision=_HIGH)  # (6,9,PM)
    Kce = jnp.einsum("kim,kjm->ijm", Le, T1, precision=_HIGH)  # (9,9,PM)

    plate_of_e = jnp.arange(PM, dtype=jnp.int32) // Mb  # (PM,)
    # local coarse dof of slot (s, m): 3*(agg - plate*nc) + m
    agg_local = agg_ids[tri] - plate_of_e[:, None] * n_coarse  # (PM,3)
    cdof = (3 * agg_local).T  # (3, PM)
    cdof = jnp.concatenate(
        [cdof[s][None].repeat(3, 0) + jnp.arange(3)[:, None] for s in range(3)]
    )  # (9, PM)
    nc3 = 3 * n_coarse
    flat = (
        plate_of_e[None, None, :] * (nc3 * nc3)
        + cdof[:, None, :] * nc3
        + cdof[None, :, :]
    ).reshape(-1)
    Kc = (
        jnp.zeros((P * nc3 * nc3,), dtype)
        .at[flat]
        .add(Kce.reshape(-1))
        .reshape(P, nc3, nc3)
    )
    d = jnp.diagonal(Kc, axis1=1, axis2=2)  # (P, nc3)
    ridge = 1e-6 * jnp.max(d, axis=1, keepdims=True) + jnp.where(
        d <= 0.0, 1.0, 0.0
    )
    return Kc + ridge[:, :, None] * jnp.eye(nc3, dtype=dtype)[None]


def coarse_apply_flat(
    Kc_inv: jnp.ndarray,  # (P, 3nc, 3nc)
    agg_ids: jnp.ndarray,  # (P*Nb,) flat
    arms: jnp.ndarray,  # (P*Nb, 2)
    r_planar: jnp.ndarray,  # (2*P*Nb,) comp-major
    P: int,
    n_coarse: int,
    fused: bool = False,
    blocked: bool = False,
) -> jnp.ndarray:
    """z = P Kc^-1 P^T r with flat shared-index segment ops and one
    batched dense matvec per plate.

    `blocked=True` requires agg_ids == arange(N) // B (contiguous
    equal-size aggregates, fem/coarse.build_block_aggregates): the
    segment ops — 48% of the shipped iteration cost
    (benchmarks/iteration_profile.py) — collapse into reshape row-sums
    and broadcasts, zero scatter/gather in the CG hot loop."""
    n = agg_ids.shape[0]
    dtype = r_planar.dtype
    rx = r_planar[:n]
    ry = r_planar[n:]
    armx = arms[:, 0].astype(dtype)
    army = arms[:, 1].astype(dtype)
    nseg = P * n_coarse
    if blocked:
        B = n // nseg
        s0 = rx.reshape(nseg, B).sum(axis=1)
        s1 = ry.reshape(nseg, B).sum(axis=1)
        s2 = (-army * rx + armx * ry).reshape(nseg, B).sum(axis=1)
        rc = jnp.stack([s0, s1, s2], axis=1).reshape(P, 3 * n_coarse)
        zc = jnp.einsum("pij,pj->pi", Kc_inv, rc, precision=_HIGH)
        zc3 = zc.reshape(nseg, 3)
        g = jnp.broadcast_to(zc3[:, None, :], (nseg, B, 3)).reshape(n, 3)
        zx = g[:, 0] - army * g[:, 2]
        zy = g[:, 1] + armx * g[:, 2]
        return jnp.concatenate([zx, zy])
    if fused:
        # One (N,3) scatter-add + one (N,3) gather instead of 3 + 3:
        # the segment ops are 48% of the shipped iteration cost
        # (benchmarks/iteration_profile.py) and XLA does not fuse
        # sibling scatters on its own.
        payload = jnp.stack(
            [rx, ry, -army * rx + armx * ry], axis=1
        )  # (N, 3)
        rc = jax.ops.segment_sum(payload, agg_ids, num_segments=nseg)
        rc = rc.reshape(P, 3 * n_coarse)  # (nseg,3) rows are [3a+m]
        zc = jnp.einsum("pij,pj->pi", Kc_inv, rc, precision=_HIGH)
        g = zc.reshape(nseg, 3)[agg_ids]  # (N, 3)
        zx = g[:, 0] - army * g[:, 2]
        zy = g[:, 1] + armx * g[:, 2]
        return jnp.concatenate([zx, zy])
    s0 = jax.ops.segment_sum(rx, agg_ids, num_segments=nseg)
    s1 = jax.ops.segment_sum(ry, agg_ids, num_segments=nseg)
    s2 = jax.ops.segment_sum(-army * rx + armx * ry, agg_ids, num_segments=nseg)
    rc = jnp.stack([s0, s1, s2], axis=1).reshape(P, 3 * n_coarse)
    zc = jnp.einsum("pij,pj->pi", Kc_inv, rc, precision=_HIGH)
    zc3 = zc.reshape(nseg, 3)
    tx = zc3[agg_ids, 0]
    ty = zc3[agg_ids, 1]
    rot = zc3[agg_ids, 2]
    zx = tx - army * rot
    zy = ty + armx * rot
    return jnp.concatenate([zx, zy])


def flat_group_body(
    coords_p,  # (P, Nb, 2)
    triangles_p,  # (P, Mb, 3)
    slots_p,  # (P, 2*Nb, W)
    agg_p,  # (P, Nb)
    arms_p,  # (P, Nb, 2)
    young_pc,  # (P, C, Mb)
    poisson_pc,  # (P, C, Mb)
    free_pc,  # (P, C, Nb)
    loads_pc,  # (P, C, Nb, 2)
    x0_pc,  # (P, C, Nb, 2)
    m_real_p=None,  # (P,) int32 real-triangle counts (banded solvers)
    *,
    n_coarse: int,
    tol: float,
    max_iters: int,
    accept_tol: float,
    restarts: int,
    include_cell_fields: bool = True,
    band_hb: int = 0,
    band_block: int = 0,
    coarse_fused: bool = False,
    coarse_blocked: bool = False,
):
    """One device program for a whole chunk. Same argument contract as
    the sharded multi-plate kernel (datagen/batched.py), same output:
    (P, C, K) packed f32 rows [u (Nb*2), (eps1 (Mb*3), sig1 (Mb*3) when
    include_cell_fields), converged, failed, rnorm, iters] — the layout
    `unpack_solve` expects."""
    P, Nb, _ = coords_p.shape
    Mb = triangles_p.shape[1]
    PN = P * Nb
    PM = P * Mb
    # band_block must tile the flat dof vector exactly (block boundaries
    # may straddle plates — harmless: plates share no elements, so the
    # straddling diagonal block is itself block-diagonal and its inverse
    # never couples them). Degrade to the largest dividing multiple of
    # BAND_R; all static python ints, resolved at trace time.
    if band_block > 0:
        band_block = max(band_block, 128)
        while band_block > 128 and (2 * PN) % band_block:
            band_block -= 128
        if (2 * PN) % band_block:
            band_block = 0
    coords, triangles, slots, agg_ids, arms = flatten_tables(
        coords_p, triangles_p, slots_p, agg_p, arms_p, n_coarse
    )
    dof_idx = element_dof_indices(triangles, PN)  # (6, PM) shared

    band_idx = None
    win_idx = None
    if band_hb > 0:
        # per-plate band indices (computed in-kernel from the triangle
        # tables already on device — nothing extra is uploaded)
        # address a (2*Nb*W,) plate-local buffer; offset by each plate's
        # row block (rows are plate-contiguous in the interleaved flat
        # dof order, so the flat system's band is the block-diagonal
        # stack of the per-plate bands)
        Wband = 2 * band_hb + 128
        p_ids = jnp.arange(P, dtype=jnp.int32)
        band_idx_p = jax.vmap(
            lambda t, m: band_assembly_indices_dev(t, m, band_hb)
        )(triangles_p, m_real_p)  # (P, 36, Mb)
        band_idx = (
            band_idx_p + (p_ids * (2 * Nb * Wband))[:, None, None]
        ).transpose(1, 0, 2).reshape(36, PM)
        win_idx = window_index(2 * PN, band_hb)

    # condition-major dense data: (P, C, ...) -> (C, flat ...)
    young_cf = young_pc.transpose(1, 0, 2).reshape(-1, PM)
    poisson_cf = poisson_pc.transpose(1, 0, 2).reshape(-1, PM)
    free_cf = free_pc.transpose(1, 0, 2).reshape(-1, PN)
    loads_cf = loads_pc.transpose(1, 0, 2, 3).reshape(-1, PN, 2)
    x0_cf = x0_pc.transpose(1, 0, 2, 3).reshape(-1, PN, 2)

    def lane(young, poisson, free, loads, x0):
        D = plane_strain_stiffness_em(young, poisson)
        Ke, B, _area = element_stiffness(coords, triangles, D)
        diag = extract_diagonal(Ke, triangles, PN)  # (PN,2)
        free_planar = jnp.concatenate([free, free])
        Dinv_band = None
        if band_hb > 0:
            S = assemble_band(Ke, band_idx, 2 * PN, band_hb)

            def op(u):
                ui = planar_to_interleaved(u, PN)
                yi = banded_matvec(S, ui, win_idx, band_hb)
                return interleaved_to_planar(yi, PN)

            if band_block > 0:
                # Band-block Jacobi: the band already materializes K's
                # (block x block) diagonal blocks as a contiguous slice,
                # so a far stronger smoother than the per-node 2x2
                # (measured 1.4-1.7x fewer CG iterations at production
                # density) costs one batched Cholesky per dispatch plus
                # a bf16 factor read (~block/(2W) of the band bytes) per
                # iteration. Gram form keeps M exactly SPD under bf16
                # rounding. Block boundaries may straddle plates —
                # harmless, plates share no elements so the straddling
                # block is itself block-diagonal.
                free_i = planar_to_interleaved(free_planar, PN)
                Dblk = band_block_diagonal(S, band_hb, band_block)
                Dinv_band = spd_block_inv_factor(
                    Dblk, free_i.reshape(-1, band_block)
                )
        else:
            op = partial(apply_element_stiffness_planar, Ke, dof_idx, slots)
        if Dinv_band is None:
            block_inv = invert_blocks(block_diagonal(Ke, triangles, PN))

        Kc_inv = None
        if n_coarse > 0:
            Kc = build_coarse_matrix_flat(
                Ke, triangles, agg_ids, arms, free, P, n_coarse
            )
            Kc_inv = jax.vmap(coarse_inverse)(Kc)

        def precondition(r):
            if Dinv_band is not None:
                zi = gram_apply(Dinv_band, planar_to_interleaved(r, PN))
                z = interleaved_to_planar(zi, PN)
            else:
                z = jnp.einsum(
                    "ijn,jn->in", block_inv, r.reshape(2, PN),
                    precision=_HIGH,
                ).reshape(-1)
            if Kc_inv is not None:
                z = z + coarse_apply_flat(
                    Kc_inv, agg_ids, arms, r, P, n_coarse,
                    fused=coarse_fused, blocked=coarse_blocked,
                )
            return z * free_planar

        res = pcg_solve_segmented(
            op,
            loads.T.reshape(-1),
            diag.T.reshape(-1),
            free_planar,
            n_seg=P,
            x0=x0.T.reshape(-1),
            tol=tol,
            max_iters=max_iters // max(restarts, 1),
            accept_tol=accept_tol,
            precondition=precondition,
            restarts=restarts,
        )
        f32 = jnp.float32
        x = res.x.reshape(2, P, Nb)  # planar -> per-plate
        u_pp = jnp.transpose(x, (1, 2, 0)).reshape(P, Nb * 2).astype(f32)
        parts = [u_pp]
        if include_cell_fields:
            xe = res.x[dof_idx]  # (6, PM)
            eps1 = jnp.einsum("ijm,jm->im", B, xe, precision=_HIGH)  # (3,PM)
            sig1 = jnp.einsum("ijm,jm->im", D, eps1, precision=_HIGH)
            for cell in (eps1, sig1):
                c = cell.reshape(3, P, Mb)
                parts.append(
                    jnp.transpose(c, (1, 2, 0)).reshape(P, Mb * 3).astype(f32)
                )
        parts.append(
            jnp.stack(
                [
                    res.converged.astype(f32),
                    res.failed.astype(f32),
                    res.residual_norm.astype(f32),
                    res.iterations.astype(f32),
                ],
                axis=1,
            )  # (P, 4)
        )
        return jnp.concatenate(parts, axis=1)  # (P, K)

    out = jax.vmap(lane)(young_cf, poisson_cf, free_cf, loads_cf, x0_cf)
    return jnp.transpose(out, (1, 0, 2))  # (P, C, K)


# Single-device entry: one jitted program per static config. Multi-device
# chunks wrap `flat_group_body` in shard_map instead (datagen/batched.py):
# each device runs this body on ITS plates only — plates are independent,
# so the right program has zero cross-device collectives (a
# vmap-over-sharded-plates lowering would all-reduce the CG while_loop
# condition every iteration).
solve_flat_group_kernel = jax.jit(
    flat_group_body,
    static_argnames=(
        "n_coarse", "tol", "max_iters", "accept_tol", "restarts",
        "include_cell_fields", "band_hb", "band_block", "coarse_fused",
        "coarse_blocked",
    ),
)
