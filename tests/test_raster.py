import numpy as np

from fea_tpu.utils import png
import pytest

from fea_tpu.mesh import read_medit_mesh, read_vtk, triangulate
from fea_tpu.raster import (
    build_pixel_map,
    field_image,
    geometry_image,
    make_frame,
    node_splat_image,
    outline_image,
    region_image,
    scalar_range,
)

CANTILEVER_DIR = "/root/reference/applications/cantilever"
UNIT_SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])


def test_devices_are_virtual_cpu_mesh():
    import jax

    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_frame_square_geometry():
    mesh = triangulate(UNIT_SQUARE, mesh_size=0.1)
    frame = make_frame(mesh.coords, 128)
    pix = frame.pixel_of_world(np.array([[0.0, 0.0], [1.0, 1.0], [0.5, 0.5]]))
    np.testing.assert_allclose(pix[0], [0, 128], atol=1e-9)  # bottom-left
    np.testing.assert_allclose(pix[1], [128, 0], atol=1e-9)  # top-right
    np.testing.assert_allclose(pix[2], [64, 64], atol=1e-9)


def test_pixel_map_interpolates_linear_field_exactly():
    mesh = triangulate(UNIT_SQUARE, mesh_size=0.1)
    pm = build_pixel_map(mesh.coords, mesh.triangles, 64)
    # A linear nodal field is reproduced exactly by barycentric interpolation.
    f = 2.0 * mesh.coords[:, 0] - 3.0 * mesh.coords[:, 1] + 0.25
    lo, hi = scalar_range(f)
    img = field_image(pm, mesh.triangles, f, (lo, hi)).astype(float)
    world = pm.frame.world_of_pixels()
    expected_field = 2.0 * world[..., 0] - 3.0 * world[..., 1] + 0.25
    expected = np.where(
        pm.inside, np.round((1 - (expected_field - lo) / (hi - lo)) * 255), 255
    )
    inner = pm.inside
    assert np.abs(img[inner] - expected[inner]).max() <= 1.0


def test_geometry_and_region_images():
    hole = np.array([[0.4, 0.4], [0.4, 0.6], [0.6, 0.6], [0.6, 0.4]])
    mesh = triangulate(UNIT_SQUARE, [hole], mesh_size=0.05)
    pm = build_pixel_map(mesh.coords, mesh.triangles, 96)
    geom = geometry_image(pm)
    assert geom[48, 48] == 255  # hole center is background
    assert geom[10, 10] == 0  # interior is black
    # region of left-half nodes
    members = np.where(mesh.coords[:, 0] < 0.5)[0]
    reg = region_image(pm, mesh.triangles, members, mesh.num_nodes)
    assert reg[48, 5] == 0
    assert reg[48, 90] == 255

    splat = node_splat_image(pm, mesh.coords, np.array([0]))
    assert (splat < 128).sum() >= 2  # corner dot drawn (clipped at edge)

    outline = outline_image(pm, mesh.coords, mesh.ring_corner_ids)
    assert (outline < 128).sum() > 50


@pytest.mark.parametrize("app", ["cantilever", "shearblade"])
@pytest.mark.parametrize("axis", [0, 1])
def test_app_raster_parity_with_vtk_render(app, axis):
    """Pixel-level parity vs the reference's VTK-rendered
    displacement_{x,y}.png (clim ±0.05, the app/metrics decode scale),
    gated for EVERY app fixture that ships a rendered PNG + solved VTK:
    cantilever and shearblade. gusset ships
    only mesh/geo/py (no VTK, no rendered PNGs) and composite's solve is
    singular garbage in the reference itself (CLAUDE.md), so those two
    have no raster fixture to gate against — gusset's FEM solve is
    covered by tests/test_apps_metrics.py::test_app_parity_vs_reference_vtk
    via the app runner instead."""
    d = f"/root/reference/applications/{app}"
    coords, tris = read_medit_mesh(f"{d}/{app}.mesh")
    u = read_vtk(f"{d}/{app}.vtk")["u"][:, :2]
    name = "displacement_x.png" if axis == 0 else "displacement_y.png"
    ref = png.to_gray(png.read_png(f"{d}/{name}")).astype(float)
    S = ref.shape[0]
    pm = build_pixel_map(coords, tris, S)
    mine = field_image(
        pm, tris, u[:, axis], value_range=(-0.05, 0.05)
    ).astype(float)
    geom = geometry_image(pm)
    interior = geom < 128
    corr = np.corrcoef(mine[interior], ref[interior])[0, 1]
    mad = np.abs(mine - ref)[interior].mean()
    assert mad < 8.0, f"{app} axis{axis}: interior MAD {mad:.2f}"
    # correlation is meaningful only when the ±0.05 clim doesn't clip
    # the field: shearblade's u_x spans -0.093..0.001, so most interior
    # pixels saturate and 1-grey-level noise dominates the corrcoef
    # (measured corr 0.824 at MAD 1.0/255 — i.e. near-bit-exact pixels,
    # garbage correlation). Near-bit-exact MAD is the stronger gate.
    assert corr > 0.95 or mad < 2.0, (
        f"{app} axis{axis}: interior corr {corr:.3f} at MAD {mad:.2f}"
    )


def test_scalar_range_capture():
    vals = np.array([-0.2, 0.1, 0.35])
    assert scalar_range(vals) == (-0.2, 0.35)
