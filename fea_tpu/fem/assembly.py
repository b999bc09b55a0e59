"""Matrix-free stiffness application for batched device solves.

Instead of materializing a sparse K (the reference hands a SciPy CSR to
SuperLU — fea_analysis.py:371-375), we keep per-element 6x6 blocks and
apply K via gather -> small batched matmul -> incidence gather-sum. The
incidence form (node dof <- fixed-width list of (element, local-dof)
slots) avoids data-dependent scatters entirely: every accumulation is a
gather followed by a fixed-width sum, with no scatter-add.
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class IncidenceOp(NamedTuple):
    """Static gather plan: for each global dof, the flat indices into the
    (6*M,) element-result vector that accumulate into it, padded with a
    sentinel slot pointing at a zeroed entry.

    Layout contract (element-minor, see elasticity.py): element results are
    (6, M) flattened as k*M + e (k = local dof 2a+comp), and global dof
    vectors are planar (2N,) ordered comp*N + node — both keep the long
    axis minor (contiguous)."""

    slots: jnp.ndarray  # (ndof, max_deg) int32 indices into padded (6*M+1,)
    n_nodes: int
    n_elements: int


def build_incidence(
    triangles: np.ndarray, n_nodes: int, pad_degree: int = 0
) -> IncidenceOp:
    """Host-side construction of the incidence plan (once per mesh/bucket).

    Vectorized NumPy group-by (no Python loop over elements). `pad_degree`
    forces a fixed table width so bucketed meshes share compiled shapes."""
    triangles = np.asarray(triangles, dtype=np.int64)
    M = len(triangles)
    ndof = 2 * n_nodes
    sentinel = M * 6  # extra zero slot

    # Per element slot (e, a, comp): planar dof = comp*N + node,
    # element-minor value = (2a + comp)*M + e.
    nodes = np.repeat(triangles.reshape(-1), 2)  # (M*3*2,)
    comp = np.tile(np.array([0, 1]), M * 3)
    dof = comp * n_nodes + nodes
    ea = np.arange(M * 3)
    vals = (2 * np.repeat(ea % 3, 2) + comp) * M + np.repeat(ea // 3, 2)

    order = np.argsort(dof, kind="stable")
    dof_s = dof[order]
    vals_s = vals[order]
    counts = np.bincount(dof, minlength=ndof)
    max_deg = int(counts.max()) if M else 1
    # Quantize table width (multiple of 8) so meshes with similar max
    # degree share compiled shapes.
    width = max(max_deg, pad_degree)
    width = ((width + 7) // 8) * 8
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(dof_s)) - np.repeat(starts, counts)

    slots = np.full((ndof, width), sentinel, dtype=np.int32)
    slots[dof_s, within] = vals_s
    return IncidenceOp(slots=jnp.asarray(slots), n_nodes=n_nodes, n_elements=M)


def element_dof_indices(triangles, n_nodes):
    """(6, M) planar dof index of each element's local dofs: row k = 2a+c
    maps to c*N + triangles[:, a]."""
    tri_t = triangles.T  # (3, M)
    return jnp.stack(
        [(k % 2) * n_nodes + tri_t[k // 2] for k in range(6)], axis=0
    )


def apply_element_stiffness_planar(Ke, dof_idx, incidence_slots, u):
    """y = K u on planar (2N,) dof vectors — the CG-loop hot path.

    Ke: (6,6,M) element-minor; dof_idx: (6,M) from element_dof_indices;
    incidence_slots: (2N, max_deg). Per iteration this moves O(M) dense,
    contiguous data."""
    ue = u[dof_idx]  # (6, M)
    fe = jnp.einsum(
        "ijm,jm->im", Ke, ue, precision=jax.lax.Precision.HIGHEST
    )  # (6, M)
    fe_flat = jnp.concatenate([fe.reshape(-1), jnp.zeros((1,), fe.dtype)])
    return fe_flat[incidence_slots].sum(axis=1)  # (2N,) planar


@partial(jax.jit, static_argnames=())
def apply_element_stiffness(Ke, triangles, incidence_slots, u):
    """y = K u for u of shape (n_nodes, 2). All shapes static.

    Ke: (6,6,M) element-minor; triangles: (M,3) int; incidence_slots:
    (2*n_nodes, max_deg). Convenience wrapper over the planar form."""
    n_nodes = u.shape[0]
    dof_idx = element_dof_indices(triangles, n_nodes)
    y = apply_element_stiffness_planar(
        Ke, dof_idx, incidence_slots, u.T.reshape(-1)
    )
    return y.reshape(2, n_nodes).T


def assemble_dense(Ke, triangles, n_nodes):
    """Dense K for small test meshes only. Ke: (6,6,M) element-minor."""
    Ke = jnp.transpose(Ke, (2, 0, 1))  # (M,6,6) for per-element flattening
    K = jnp.zeros((2 * n_nodes, 2 * n_nodes), Ke.dtype)
    dofs = jnp.stack(
        [triangles * 2 + 0, triangles * 2 + 1], axis=-1
    ).reshape(-1, 6)  # (M,6): interleaved (x0,y0,x1,y1,x2,y2)
    rows = dofs[:, :, None].repeat(6, axis=2)
    cols = dofs[:, None, :].repeat(6, axis=1)
    return K.at[rows.reshape(-1), cols.reshape(-1)].add(Ke.reshape(-1))


def assemble_scipy_csr(Ke, triangles, n_nodes):
    """SciPy CSR assembly — host-side reference/direct-solve path for tests."""
    import scipy.sparse as sp

    Ke = np.asarray(Ke)
    triangles = np.asarray(triangles)
    dofs = np.stack([triangles * 2, triangles * 2 + 1], axis=-1).reshape(-1, 6)
    rows = np.repeat(dofs, 6, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, 6)).reshape(-1)
    return sp.coo_matrix(
        (Ke.reshape(-1), (rows, cols)), shape=(2 * n_nodes, 2 * n_nodes)
    ).tocsr()
