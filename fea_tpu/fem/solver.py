"""Batched Jacobi-preconditioned conjugate-gradient solver.

The accelerator replacement for the reference's ScipyDirect (SuperLU)
sparse LU (fea_analysis.py:371-375). Matrix-free, static shapes, runs
under jit/vmap, reports convergence + NaN flags that feed the host-side
condition-resampling loop (reference datagen/generate.py:110-124).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Inner products of the CG recurrences at full f32 precision: a
# reduced-precision (TF32) dot would perturb the recurrence.
_HIGH = jax.lax.Precision.HIGHEST


class CGResult(NamedTuple):
    x: jnp.ndarray
    residual_norm: jnp.ndarray  # final |r| / |b|
    iterations: jnp.ndarray
    converged: jnp.ndarray
    failed: jnp.ndarray  # NaN/Inf detected (singular or blow-up)


def block_diagonal(Ke, triangles, n_nodes):
    """Per-node 2x2 diagonal blocks of K (block-Jacobi preconditioner —
    markedly more robust than scalar Jacobi for elasticity, especially with
    the zero-stiffness straddling cells the region semantics produce).

    Ke: (6,6,M) element-minor. Returns (2,2,N) — node axis minor, like
    every per-element/per-node array of the solver."""
    # Ke dof order (x0,y0,x1,y1,x2,y2): node-a self block = Ke[2a:2a+2, 2a:2a+2]
    out = jnp.zeros((2, 2, n_nodes), Ke.dtype)
    for a in range(3):
        idx = triangles[:, a]
        for i in range(2):
            for j in range(2):
                out = out.at[i, j, idx].add(Ke[2 * a + i, 2 * a + j])
    return out


def invert_blocks(blocks):
    """Inverse of 2x2 SPD blocks (2,2,N); identity on fixed/empty nodes
    (fixed-dof masking is the CG loop's job — it zeroes r at fixed dofs
    before every preconditioner apply)."""
    a = blocks[0, 0]
    b = blocks[0, 1]
    c = blocks[1, 0]
    d = blocks[1, 1]
    det = a * d - b * c
    ok = jnp.abs(det) > 1e-30
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    one = jnp.ones_like(a)
    zero = jnp.zeros_like(a)
    inv = jnp.stack(
        [
            jnp.stack(
                [jnp.where(ok, d * inv_det, one), jnp.where(ok, -b * inv_det, zero)],
                axis=0,
            ),
            jnp.stack(
                [jnp.where(ok, -c * inv_det, zero), jnp.where(ok, a * inv_det, one)],
                axis=0,
            ),
        ],
        axis=0,
    )  # (2,2,N)
    # zero rows/cols for fixed nodes are handled by the free mask outside
    return inv


def pcg_solve(
    operator,
    b,
    diag,
    free_mask,
    x0=None,
    tol: float = 1e-10,
    max_iters: int = 2000,
    accept_tol: float = None,
    precondition=None,
    restarts: int = 1,
) -> CGResult:
    """Solve A x = b on the free dofs with Jacobi preconditioning.

    operator: callable u -> K u on full dof vectors (any pytree-free shape).
    b: RHS, same shape; entries at constrained dofs are ignored.
    diag: diagonal of K (for the Jacobi preconditioner), same shape.
    free_mask: 1.0 for free dofs, 0.0 for Dirichlet-constrained dofs.
    Constrained dofs are held at zero (reference uses u.all = 0 EBCs only,
    fea_analysis.py:363-369).
    precondition: optional callable r -> M^-1 r (must zero constrained
    dofs); defaults to scalar Jacobi from `diag`.

    `tol` drives the iteration; `converged` reports whether the recomputed
    true residual met `accept_tol` (default 100x tol — CG recurrence can
    stagnate slightly above the target at the dtype's roundoff floor).

    Stagnation early-exit: lanes that hit their f32 roundoff floor stop
    iterating (no 10% residual reduction within `stall_limit` iterations)
    and skip their remaining restarts (no 10% reduction across a whole
    restart). Under vmap a while_loop runs until EVERY lane's cond is
    false, so without this a single hopeless condition (hinge mechanism)
    drags the whole plate-group kernel to restarts*max_iters — minutes of
    device time burned on a solve the caller will resample anyway (and
    long enough to trip remote-execution watchdogs).
    """
    if accept_tol is None:
        accept_tol = tol * 100.0
    stall_limit = 180
    dtype = b.dtype
    free = free_mask.astype(dtype)
    bm = b * free
    inv_diag = free / jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)

    def A(u):
        return operator(u * free) * free

    if precondition is None:

        def precondition(r):
            return inv_diag * r

    b_norm = jnp.sqrt(jnp.vdot(bm, bm, precision=_HIGH))
    b_norm = jnp.where(b_norm > 0, b_norm, 1.0)
    atol2 = (tol * b_norm) ** 2

    def cond(state):
        x, r, p, rz, k, best_r2, stall, active = state
        r2 = jnp.vdot(r, r, precision=_HIGH)
        not_done = (r2 > atol2) & (k < max_iters)
        healthy = jnp.isfinite(r2)
        return not_done & healthy & (stall < stall_limit) & active

    def body(state):
        x, r, p, rz, k, best_r2, stall, active = state
        Ap = A(p)
        pAp = jnp.vdot(p, Ap, precision=_HIGH)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precondition(r)
        rz_new = jnp.vdot(r, z, precision=_HIGH)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        p = z + beta * p
        r2 = jnp.vdot(r, r, precision=_HIGH)
        improved = r2 < 0.9 * best_r2
        best_r2 = jnp.where(improved, r2, best_r2)
        stall = jnp.where(improved, 0, stall + 1)
        return (x, r, p, rz_new, k + 1, best_r2, stall, active)

    # Restarted CG (iterative refinement): each restart recomputes the true
    # residual, killing the conjugacy/residual drift that stalls or diverges
    # single-sweep CG in float32 on ill-conditioned plates.
    x = jnp.zeros_like(bm) if x0 is None else x0 * free
    total_iters = jnp.array(0)
    active = jnp.array(True)
    for _ in range(max(restarts, 1)):
        r = bm - A(x)
        z = precondition(r)
        rz = jnp.vdot(r, z, precision=_HIGH)
        # a NaN-poisoned x would propagate: reset instead (keeps while_loop
        # shapes static, costs nothing in the healthy path)
        healthy = jnp.isfinite(rz)
        x = jnp.where(healthy, x, 0.0)
        r = jnp.where(healthy, r, bm)
        z = jnp.where(healthy, z, precondition(bm))
        rz = jnp.where(healthy, rz, jnp.vdot(r, precondition(r), precision=_HIGH))
        r2_start = jnp.vdot(r, r, precision=_HIGH)
        x, r, p, rz, k, _, _, _ = jax.lax.while_loop(
            cond,
            body,
            (x, r, z, rz, jnp.array(0), r2_start, jnp.array(0), active),
        )
        total_iters = total_iters + k
        # Give up remaining restarts once a full restart stops helping
        # (already converged lanes exit instantly via the r2 > atol2 cond).
        r2_end = jnp.vdot(r, r, precision=_HIGH)
        active = active & (r2_end < 0.9 * r2_start)

    # Recompute true residual for reporting.
    rtrue = bm - A(x)
    rnorm = jnp.sqrt(jnp.vdot(rtrue, rtrue, precision=_HIGH)) / b_norm
    failed = ~jnp.isfinite(rnorm) | ~jnp.all(jnp.isfinite(x))
    converged = (rnorm <= accept_tol) & ~failed
    return CGResult(
        x=x * free,
        residual_norm=rnorm,
        iterations=total_iters,
        converged=converged,
        failed=failed,
    )


def pcg_solve_segmented(
    operator,
    b,
    diag,
    free_mask,
    n_seg: int,
    x0=None,
    tol: float = 1e-10,
    max_iters: int = 2000,
    accept_tol: float = None,
    precondition=None,
    restarts: int = 1,
) -> CGResult:
    """PCG on a block-diagonal super-system of `n_seg` independent
    segments (plates) with PER-SEGMENT alpha/beta/convergence.

    Vectors are planar over the concatenated node axis: (2 * n_seg * Ns),
    component-major, segments contiguous within each component block —
    so every segment reduction is a reshape to (2, n_seg, Ns) and a sum,
    and every scalar broadcast is the inverse reshape. No gathers.

    Mathematically identical to running `pcg_solve` per segment (the
    scalars decouple exactly on a block-diagonal operator), but one
    device program: the operator/preconditioner run over the whole flat
    vector with shared constant index tables (see fem/flatgroup.py).
    Segments that converge freeze (their updates are masked) while the
    remaining segments iterate; the loop exits when every segment is
    done, stalled (no 10% residual reduction in `stall_limit` iters at
    its f32 floor), or out of budget.

    Returns CGResult with per-segment residual_norm / iterations /
    converged / failed arrays of shape (n_seg,)."""
    if accept_tol is None:
        accept_tol = tol * 100.0
    stall_limit = 180
    dtype = b.dtype
    free = free_mask.astype(dtype)
    bm = b * free
    ndof = b.shape[0]
    Ns = ndof // (2 * n_seg)

    def sdot(u, v):
        return (u * v).reshape(2, n_seg, Ns).sum(axis=(0, 2))

    def expand(s):  # (n_seg,) -> (ndof,)
        return jnp.broadcast_to(
            s[None, :, None], (2, n_seg, Ns)
        ).reshape(-1)

    inv_diag = free / jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)

    def A(u):
        return operator(u * free) * free

    if precondition is None:

        def precondition(r):
            return inv_diag * r

    b_norm = jnp.sqrt(sdot(bm, bm))
    b_norm = jnp.where(b_norm > 0, b_norm, 1.0)
    atol2 = (tol * b_norm) ** 2

    def running_of(state):
        x, r, p, rz, k, best_r2, stall, active = state
        r2 = sdot(r, r)
        return (
            (r2 > atol2)
            & jnp.isfinite(r2)
            & (stall < stall_limit)
            & active
        )

    def cond(state):
        k = state[4]
        return jnp.any(running_of(state)) & (k < max_iters)

    def body(state):
        x, r, p, rz, k, best_r2, stall, active = state
        run = running_of(state)
        m = expand(run.astype(dtype))
        Ap = A(p)
        pAp = sdot(p, Ap)
        alpha = jnp.where(run, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
        x = x + expand(alpha) * p
        r = r - expand(alpha) * Ap
        z = precondition(r)
        rz_new = sdot(r, z)
        beta = jnp.where(run, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
        p = jnp.where(m > 0, z + expand(beta) * p, p)
        rz = jnp.where(run, rz_new, rz)
        r2 = sdot(r, r)
        improved = run & (r2 < 0.9 * best_r2)
        best_r2 = jnp.where(improved, r2, best_r2)
        stall = jnp.where(improved, 0, jnp.where(run, stall + 1, stall))
        return (x, r, p, rz, k + 1, best_r2, stall, active)

    x = jnp.zeros_like(bm) if x0 is None else x0 * free
    total_iters = jnp.zeros((n_seg,), jnp.int32)
    active = jnp.ones((n_seg,), bool)
    for _ in range(max(restarts, 1)):
        r = bm - A(x)
        z = precondition(r)
        rz = sdot(r, z)
        healthy = jnp.isfinite(rz)
        hm = expand(healthy.astype(dtype))
        x = jnp.where(hm > 0, x, 0.0)
        r = jnp.where(hm > 0, r, bm)
        z = jnp.where(hm > 0, z, precondition(bm))
        rz = jnp.where(healthy, rz, sdot(r, precondition(r)))
        r2_start = sdot(r, r)
        k0 = jnp.array(0)
        state = (x, r, z, rz, k0, r2_start, jnp.zeros((n_seg,), jnp.int32), active)
        x, r, p, rz, k, _, _, _ = jax.lax.while_loop(cond, body, state)
        # per-segment iteration count: segments that finished early kept
        # their stall/convergence state; attribute the loop's k to every
        # segment that was active this restart (upper bound per segment,
        # exact for the lockstep cost the device actually paid)
        total_iters = total_iters + jnp.where(active, k, 0).astype(jnp.int32)
        r2_end = sdot(r, r)
        active = active & (r2_end < 0.9 * r2_start)

    rtrue = bm - A(x)
    rnorm = jnp.sqrt(sdot(rtrue, rtrue)) / b_norm
    finite_x = ~jnp.any(
        ~jnp.isfinite(x).reshape(2, n_seg, Ns), axis=(0, 2)
    )
    failed = ~jnp.isfinite(rnorm) | ~finite_x
    converged = (rnorm <= accept_tol) & ~failed
    return CGResult(
        x=x * free,
        residual_norm=rnorm,
        iterations=total_iters,
        converged=converged,
        failed=failed,
    )


def extract_diagonal(Ke, triangles, n_nodes):
    """Diagonal of assembled K from element blocks (for Jacobi).

    Ke: (6,6,M) element-minor. Returns (N,2)."""
    out = jnp.zeros((2, n_nodes), Ke.dtype)
    for a in range(3):
        idx = triangles[:, a]
        for c in range(2):
            out = out.at[c, idx].add(Ke[2 * a + c, 2 * a + c])
    return out.T
