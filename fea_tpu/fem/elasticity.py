"""2D linear elasticity: constitutive matrices and P1 element stiffness.

Matches sfepy's `stiffness_from_youngpoisson(dim=2, ...)` defaults (plane
strain), used by the reference for every material region
(fea_analysis.py:257-266).
"""

import jax
import jax.numpy as jnp


def plane_strain_stiffness(young, poisson):
    """Plane-strain D (..., 3, 3) from Young's modulus / Poisson ratio.

    D = [[lam+2mu, lam, 0], [lam, lam+2mu, 0], [0, 0, mu]] with the
    engineering-shear Voigt convention (exx, eyy, 2*exy).
    """
    young = jnp.asarray(young)
    poisson = jnp.asarray(poisson)
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    mu = young / (2.0 * (1.0 + poisson))
    zeros = jnp.zeros_like(lam)
    row0 = jnp.stack([lam + 2 * mu, lam, zeros], axis=-1)
    row1 = jnp.stack([lam, lam + 2 * mu, zeros], axis=-1)
    row2 = jnp.stack([zeros, zeros, mu], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def plane_stress_stiffness(young, poisson):
    """Plane-stress variant (sfepy's plane='stress' option)."""
    young = jnp.asarray(young)
    poisson = jnp.asarray(poisson)
    c = young / (1.0 - poisson**2)
    zeros = jnp.zeros_like(c)
    row0 = jnp.stack([c, c * poisson, zeros], axis=-1)
    row1 = jnp.stack([c * poisson, c, zeros], axis=-1)
    row2 = jnp.stack([zeros, zeros, c * (1 - poisson) / 2], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def element_stiffness_np(coords, triangles, young, poisson):
    """Float64 NumPy element stiffness — host-side exact assembly for the
    mixed-precision refinement path (independent of jax_enable_x64).
    Returns (Ke (M,6,6), B (M,3,6), D (M,3,3), area (M,))."""
    import numpy as np

    coords = np.asarray(coords, np.float64)
    triangles = np.asarray(triangles)
    young = np.asarray(young, np.float64)
    poisson = np.asarray(poisson, np.float64)
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    mu = young / (2.0 * (1.0 + poisson))
    zeros = np.zeros_like(lam)
    D = np.stack(
        [
            np.stack([lam + 2 * mu, lam, zeros], axis=-1),
            np.stack([lam, lam + 2 * mu, zeros], axis=-1),
            np.stack([zeros, zeros, mu], axis=-1),
        ],
        axis=-2,
    )
    p = coords[triangles]
    x, y = p[..., 0], p[..., 1]
    b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], -1)
    c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], -1)
    area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
    area = 0.5 * area2
    bn = b / area2[:, None]
    cn = c / area2[:, None]
    z = np.zeros_like(bn)
    rxx = np.stack([bn[:, 0], z[:, 0], bn[:, 1], z[:, 1], bn[:, 2], z[:, 2]], -1)
    ryy = np.stack([z[:, 0], cn[:, 0], z[:, 1], cn[:, 1], z[:, 2], cn[:, 2]], -1)
    rxy = np.stack([cn[:, 0], bn[:, 0], cn[:, 1], bn[:, 1], cn[:, 2], bn[:, 2]], -1)
    B = np.stack([rxx, ryy, rxy], -2)
    Ke = np.einsum("mji,mjk,mkl->mil", B, D, B) * area[:, None, None]
    return Ke, B, D, area


def plane_strain_stiffness_em(young, poisson):
    """Element-minor plane-strain D: (3, 3, M) for per-element (M,) inputs.

    Keeping the long element axis minor (last) keeps every per-element
    quantity contiguous along M, across vmapped plates/conditions."""
    young = jnp.asarray(young)
    poisson = jnp.asarray(poisson)
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    mu = young / (2.0 * (1.0 + poisson))
    zeros = jnp.zeros_like(lam)
    return jnp.stack(
        [
            jnp.stack([lam + 2 * mu, lam, zeros], axis=0),
            jnp.stack([lam, lam + 2 * mu, zeros], axis=0),
            jnp.stack([zeros, zeros, mu], axis=0),
        ],
        axis=0,
    )  # (3, 3, M)


def triangle_geometry(coords, triangles):
    """Per-element B-matrix ingredients for P1 triangles, element-minor.

    Returns (B (3,6,M), area (M,)). B maps the 6 nodal dofs
    (ux0, uy0, ux1, uy1, ux2, uy2) to Voigt strain (exx, eyy, 2exy).
    Corner coordinates are gathered one (M,) vector at a time, so no
    (M,3,2) intermediate with tiny minor dims is materialized."""
    x = coords[:, 0]
    y = coords[:, 1]
    t0, t1, t2 = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    x0, x1, x2 = x[t0], x[t1], x[t2]
    y0, y1, y2 = y[t0], y[t1], y[t2]
    # Shape-function gradient coefficients, (3, M).
    b = jnp.stack([y1 - y2, y2 - y0, y0 - y1], axis=0)
    c = jnp.stack([x2 - x1, x0 - x2, x1 - x0], axis=0)
    area2 = x0 * b[0] + x1 * b[1] + x2 * b[2]  # 2*area, (M,)
    area = 0.5 * area2
    inv = 1.0 / area2
    bn = b * inv  # dN/dx, (3, M)
    cn = c * inv  # dN/dy
    zeros = jnp.zeros_like(bn[0])
    # Rows: exx from ux via dN/dx; eyy from uy via dN/dy; 2exy mixes both.
    row_xx = jnp.stack([bn[0], zeros, bn[1], zeros, bn[2], zeros], axis=0)
    row_yy = jnp.stack([zeros, cn[0], zeros, cn[1], zeros, cn[2]], axis=0)
    row_xy = jnp.stack([cn[0], bn[0], cn[1], bn[1], cn[2], bn[2]], axis=0)
    B = jnp.stack([row_xx, row_yy, row_xy], axis=0)  # (3, 6, M)
    return B, area


def element_stiffness(coords, triangles, D):
    """Per-element 6x6 stiffness Ke = area * B^T D B, element-minor.

    D: (3,3) shared, or (3,3,M) per element (see plane_strain_stiffness_em).
    Returns (Ke (6,6,M), B (3,6,M), area (M,)). The (i,j) contractions are
    over the tiny 3-dim — XLA unrolls them into fused multiply-adds over
    the element axis (elementwise work; 3x3 contractions gain nothing
    from a matrix unit)."""
    B, area = triangle_geometry(coords, triangles)
    if D.ndim == 2:
        D = jnp.broadcast_to(D[:, :, None], (3, 3, B.shape[-1]))
    # Precision.HIGHEST: a reduced-precision f32 contraction (bf16 passes,
    # or TF32 on GPUs) corrupts the stiffness (up to 7.5% displacement
    # error observed with bf16 passes).
    DB = jnp.einsum(
        "ijm,jkm->ikm", D, B, precision=jax.lax.Precision.HIGHEST
    )
    Ke = (
        jnp.einsum("jim,jkm->ikm", B, DB, precision=jax.lax.Precision.HIGHEST)
        * area[None, None, :]
    )
    return Ke, B, area
