"""Banded stiffness operator: the zero-gather CG matvec.

The matrix-free incidence operator (assembly.py) spends its time in
per-iteration gathers (element-dof gather + incidence gather-sum) with
data-dependent addresses.

This module reformulates K·u as a *dense banded* product instead:

  * host side, once per mesh: a reverse-Cuthill-McKee permutation of the
    nodes. Real datagen meshes (mesh_size 1e-2, ~4-8k nodes) have RCM
    node bandwidth 50-120, i.e. interleaved-dof half-bandwidth ~105-240
    — tiny next to the 16k dof vector;
  * once per solve: K's element blocks are scatter-added into a
    block-shifted dense band S of shape (n_blocks, R, W) where row
    block b holds rows [bR, bR+R) and column c of block b is global
    column bR + c - hb. Every K entry with |i-j| <= hb has a slot
    (W = 2*hb + R), so S·window == K·u exactly;
  * every CG iteration: y = einsum('brw,bw->br', S, windows(u)) — one
    batched dense matmul with a static-index window gather, no
    data-dependent addressing at all. It reads the whole band (W entries
    per row against ~14 nonzeros of K), so it is bound by device-memory
    bandwidth, and the window/einsum pattern scales with bandwidth, not
    node count.

The permutation lives entirely inside the solver scaffold: conditions
are built on the original mesh, per-condition arrays are permuted on
host at dispatch, and displacements are unpermuted at fetch, so the
node-ordering contract (corner vertices first — mesh/mesher.py) is
unchanged for every consumer.

Replaces the reference's SciPy-CSR + SuperLU representation
(datagen/fea_analysis.py:371-375) on the datagen hot path.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_HIGH = jax.lax.Precision.HIGHEST

# Rows per band block; every node bucket is a multiple of 64 so 2*Nb is
# always divisible by R.
BAND_R = 128


def quantize_hb(hb: int) -> int:
    """Round a dof half-bandwidth up to a multiple of 64 so grouped
    plates share compiled band shapes (W = 2*hb + R stays a multiple of
    128)."""
    return max(64, ((int(hb) + 63) // 64) * 64)


def rcm_permutation(triangles: np.ndarray, n_nodes: int):
    """RCM node ordering for bandwidth reduction.

    Returns (perm, hb_dof): `perm[k]` = original node id placed at
    position k, and the natural interleaved-dof half-bandwidth of the
    permuted mesh (2*node_bw + 1, unquantized)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    tri = np.asarray(triangles, dtype=np.int64)
    rows = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2]])
    cols = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0]])
    adj = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n_nodes, n_nodes)
    )
    adj = (adj + adj.T).tocsr()
    perm = np.asarray(
        reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64
    )
    inv = np.empty(n_nodes, np.int64)
    inv[perm] = np.arange(n_nodes)
    node_bw = int(np.abs(inv[rows] - inv[cols]).max()) if len(rows) else 1
    return perm, 2 * node_bw + 1


def band_assembly_indices(
    triangles: np.ndarray, n_nodes: int, hb: int
) -> np.ndarray:
    """Static scatter plan: flat indices into the (2*n_nodes * W,) band
    buffer for every (k1, k2, e) entry of the element-minor Ke (6,6,M).

    `triangles` must already be in the permuted (banded) node order and
    satisfy |i-j| <= hb for every element edge. Returns (36, M) int32."""
    tri = np.asarray(triangles, dtype=np.int64)
    M = len(tri)
    W = 2 * hb + BAND_R
    k = np.arange(6)
    # interleaved dof of local dof k for each element: 2*node + comp
    dof = 2 * tri[:, k // 2] + (k % 2)  # (M, 6)
    i = dof[:, :, None]  # (M, 6, 1) row
    j = dof[:, None, :]  # (M, 1, 6) col
    c = j - (i // BAND_R) * BAND_R + hb
    if c.size and (c.min() < 0 or c.max() >= W):
        raise ValueError(
            f"band half-width {hb} too small for mesh (c range "
            f"[{c.min()}, {c.max()}], W={W})"
        )
    flat = i * W + c  # (M, 6, 6); row-major over (i, c)
    # Ke layout is (k1, k2, e) element-minor -> reorder to (36, M)
    return np.ascontiguousarray(
        flat.transpose(1, 2, 0).reshape(36, M)
    ).astype(np.int32)


def band_assembly_indices_dev(triangles, m_real, hb: int):
    """Device-side band scatter plan: jnp twin of `band_assembly_indices`
    for the flat chunk kernel.

    The plan is a pure function of (triangles, hb), and triangles already
    live on device — computing the (36, Mb) index table in-kernel avoids
    uploading ~3.4 MB per solver + ~28 MB per chunk. `m_real` masks ghost padding triangles to node 0 (their Ke is
    exactly zero). No host-side validation here: PlateSolver guarantees
    hb >= the RCM bandwidth of the real triangles by construction."""
    Mb = triangles.shape[0]
    tri = jnp.where(
        jnp.arange(Mb, dtype=jnp.int32)[:, None] < m_real,
        triangles.astype(jnp.int32),
        0,
    )
    k = jnp.arange(6, dtype=jnp.int32)
    dof = 2 * tri[:, k // 2] + (k % 2)  # (Mb, 6)
    i = dof[:, :, None]
    j = dof[:, None, :]
    W = 2 * hb + BAND_R
    c = j - (i // BAND_R) * BAND_R + hb
    flat = i * W + c  # (Mb, 6, 6)
    return flat.transpose(1, 2, 0).reshape(36, Mb)


def assemble_band(Ke, band_idx, n_dofs: int, hb: int):
    """Scatter-add the element blocks into the block-shifted band.

    Ke: (6,6,M) element-minor; band_idx: (36, M) int32 (flat-chunk
    callers pre-offset per plate). Returns S (n_dofs//R, R, W). One
    scatter per solve, amortized over the CG iterations (~0.1 ms/lane
    per eventual iteration at the datagen shape)."""
    W = 2 * hb + BAND_R
    S = jnp.zeros((n_dofs * W,), Ke.dtype)
    S = S.at[band_idx.reshape(-1)].add(Ke.reshape(-1))
    return S.reshape(n_dofs // BAND_R, BAND_R, W)


def window_index(n_dofs: int, hb: int) -> jnp.ndarray:
    """(n_blocks, W) static indices into the hb-padded dof vector:
    window b covers padded positions [bR, bR + W)."""
    W = 2 * hb + BAND_R
    nblk = n_dofs // BAND_R
    return (
        jnp.arange(nblk, dtype=jnp.int32)[:, None] * BAND_R
        + jnp.arange(W, dtype=jnp.int32)[None, :]
    )


def banded_matvec(S, x, win_idx, hb: int):
    """y = K x on interleaved (n_dofs,) vectors via the block-shifted
    band: window gather (static indices) + one batched matmul."""
    x_pad = jnp.pad(x, (hb, hb))
    Xw = x_pad[win_idx]  # (nblk, W)
    y = jnp.einsum("brw,bw->br", S, Xw, precision=_HIGH)
    return y.reshape(-1)


def band_block_diagonal(S, hb: int, block: int):
    """Extract K's (block x block) diagonal blocks from the band.

    S: (nblk, R, W) block-shifted band (assemble_band). `block` must be a
    multiple of BAND_R. Returns (n_dofs // block, block, block).

    Band geometry: S[i // R, i % R, j - (i // R) * R + hb] = K[i, j], so
    the diagonal block g (rows/cols [g*block, (g+1)*block)) is a pure
    static-index gather. Entries whose column offset falls outside the
    band window satisfy |i - j| > hb and are exactly zero in K (the band
    holds every nonzero by construction) — masked to 0 here. All index
    math is device-side iota (no host constants: baking a (nb, B, B)
    int32 table into the program would upload tens of MB per compile).
    """
    nblk, R, W = S.shape
    n_dofs = nblk * R
    nb = n_dofs // block
    g = jnp.arange(nb, dtype=jnp.int32)[:, None, None]
    r = jnp.arange(block, dtype=jnp.int32)[None, :, None]
    s = jnp.arange(block, dtype=jnp.int32)[None, None, :]
    i = g * block + r
    j = g * block + s
    c = j - (i // R) * R + hb
    valid = (c >= 0) & (c < W)
    flat = i * W + jnp.where(valid, c, 0)
    D = S.reshape(-1)[flat.reshape(-1)].reshape(nb, block, block)
    return D * valid.astype(S.dtype)


def spd_block_inverse(D, free_blocks, ridge: float = 1e-7):
    """Exact-PSD inverse of masked SPD diagonal blocks.

    D: (nb, B, B); free_blocks: (nb, B) 1.0 free / 0.0 fixed. Fixed (and
    ghost-padding) rows/cols are zeroed and given a unit diagonal before
    factorization, then re-masked to zero after, so the preconditioner
    never injects residual at constrained dofs. A relative ridge keeps
    the Cholesky PD against zero-stiffness straddling cells.

    Returned as Linv^T Linv (Gram form): symmetric by construction and
    PSD under any rounding — CG theory requires an SPD M even in f32.
    A block whose factorization still fails (NaN) degrades to its
    scalar-Jacobi inverse rather than poisoning the lane."""
    nb, B, _ = D.shape
    dtype = D.dtype
    f = free_blocks.astype(dtype)
    Dm = D * f[:, :, None] * f[:, None, :]
    diag = jnp.diagonal(Dm, axis1=1, axis2=2)  # (nb, B)
    mx = jnp.max(diag, axis=1, keepdims=True)
    add = ridge * mx + jnp.where(diag <= 0.0, 1.0, 0.0)
    eye = jnp.eye(B, dtype=dtype)
    Dm = Dm + add[:, :, None] * eye[None]
    L = jnp.linalg.cholesky(Dm)
    Linv = jax.lax.linalg.triangular_solve(
        L, jnp.broadcast_to(eye, (nb, B, B)),
        left_side=True, lower=True,
    )
    inv = jnp.einsum("gki,gkj->gij", Linv, Linv, precision=_HIGH)
    inv = inv * f[:, :, None] * f[:, None, :]
    # degrade failed blocks to scalar Jacobi (still SPD)
    ok = jnp.all(jnp.isfinite(inv), axis=(1, 2), keepdims=True)
    jac = jnp.where(diag > 0.0, f / jnp.where(diag > 0.0, diag, 1.0), 0.0)
    return jnp.where(ok, inv, jac[:, :, None] * eye[None])


def block_jacobi_apply(Dinv, x):
    """z = blockdiag(Dinv) x on interleaved (n_dofs,) vectors."""
    nb, B, _ = Dinv.shape
    z = jnp.einsum(
        "gij,gj->gi", Dinv, x.reshape(nb, B), precision=_HIGH
    )
    return z.reshape(-1)


def spd_block_inv_factor(D, free_blocks, ridge: float = 1e-7,
                         out_dtype=jnp.bfloat16):
    """Inverse Cholesky factor Linv of masked SPD diagonal blocks, for
    the Gram-form preconditioner apply M r = Linv^T (Linv r).

    Same masking/ridge contract as `spd_block_inverse`, but returning
    the factor halves the per-iteration HBM read when stored bf16
    (out_dtype): M = L~^T L~ is symmetric PSD BY CONSTRUCTION for any
    rounding of the factor — unlike rounding an explicit inverse, which
    can flip small eigenvalues negative and break CG. A block whose
    factorization fails degrades to scalar Jacobi (diag^-1/2 on the
    diagonal — its Gram square is the scalar-Jacobi inverse)."""
    nb, B, _ = D.shape
    dtype = D.dtype
    f = free_blocks.astype(dtype)
    Dm = D * f[:, :, None] * f[:, None, :]
    diag = jnp.diagonal(Dm, axis1=1, axis2=2)  # (nb, B)
    mx = jnp.max(diag, axis=1, keepdims=True)
    add = ridge * mx + jnp.where(diag <= 0.0, 1.0, 0.0)
    eye = jnp.eye(B, dtype=dtype)
    Dm = Dm + add[:, :, None] * eye[None]
    L = jnp.linalg.cholesky(Dm)
    Linv = jax.lax.linalg.triangular_solve(
        L, jnp.broadcast_to(eye, (nb, B, B)),
        left_side=True, lower=True,
    )
    # mask columns at fixed dofs so M never injects residual there
    # (rows of Linv at fixed dofs are e_i / sqrt(1 + ridge*mx); their
    # Gram contribution only touches fixed entries, killed by masking)
    Linv = Linv * f[:, None, :]
    ok = jnp.all(jnp.isfinite(Linv), axis=(1, 2), keepdims=True)
    jac = jnp.where(
        diag > 0.0, f / jnp.sqrt(jnp.where(diag > 0.0, diag, 1.0)), 0.0
    )
    Linv = jnp.where(ok, Linv, jac[:, :, None] * eye[None])
    return Linv.astype(out_dtype)


def gram_apply(Linv, x):
    """z = blockdiag(Linv^T Linv) x on interleaved (n_dofs,) vectors.

    Two batched matvecs; f32 accumulation regardless of the factor's
    storage dtype (bf16 factors are converted in registers — HBM reads
    stay half-width)."""
    nb, B, _ = Linv.shape
    acc = jnp.float32 if Linv.dtype == jnp.bfloat16 else Linv.dtype
    xb = x.reshape(nb, B)
    y = jnp.einsum(
        "gij,gj->gi", Linv, xb.astype(Linv.dtype),
        precision=_HIGH, preferred_element_type=acc,
    )
    z = jnp.einsum(
        "gji,gj->gi", Linv, y.astype(Linv.dtype),
        precision=_HIGH, preferred_element_type=acc,
    )
    return z.reshape(-1).astype(x.dtype)


def planar_to_interleaved(u, n):
    """(2n,) comp-major planar -> (2n,) node-interleaved."""
    return u.reshape(2, n).T.reshape(-1)


def interleaved_to_planar(u, n):
    """(2n,) node-interleaved -> (2n,) comp-major planar."""
    return u.reshape(n, 2).T.reshape(-1)
