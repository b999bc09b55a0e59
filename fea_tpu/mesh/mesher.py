"""Triangle meshing of plate polygons via the native C++ CDT library.

Replaces gmsh in the reference pipeline (datagen/mesh_generator.py:246-317).
The node-ordering contract mirrors gmsh's "geometry points get the first
tags": nodes 0..P-1 are the polygon corner vertices — exterior ring first,
then hole rings in order — so condition sampling and the collinear-edge
region predicate (reference fea_analysis.py:183-188) work on node indices.

The library is built with g++ on first use, into a file named by a hash
of the source, the compiler flags, the compiler's version and the
machine, so a library built elsewhere is never loaded. If it cannot be
built, a SciPy-Delaunay fallback meshes instead (for test environments:
its meshes differ) and says so on stderr.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..geometry.polygon import Polygon

_CDT_DIR = os.path.join(os.path.dirname(__file__), "cdt")
_SRC_PATH = os.path.join(_CDT_DIR, "cdt.cpp")
_CXX = "g++"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class MeshError(Exception):
    """Meshing failed (capacity, degeneracy, or non-conforming boundary)."""


@dataclass
class Mesh:
    """Static triangle mesh with the boundary-tag contract.

    coords: (N, 2) float64 node coordinates.
    triangles: (M, 3) int32 CCW node indices.
    ring_corner_ids: per ring (exterior first, then holes), the node indices
        of the polygon's corner vertices, in ring order. Equivalent to the
        reference's polygons_ptags (mesh_generator.py:253,288).
    ring_edges: per ring, list of (corner_id0, corner_id1) for each polygon
        edge — the reference's polygons_ltag_ptags values.
    """

    coords: np.ndarray
    triangles: np.ndarray
    ring_corner_ids: List[np.ndarray] = field(default_factory=list)
    ring_edges: List[List[Tuple[int, int]]] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.coords)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def all_corner_ids(self) -> List[int]:
        return [int(i) for ring in self.ring_corner_ids for i in ring]

    def all_edges(self) -> List[Tuple[int, int]]:
        return [e for ring in self.ring_edges for e in ring]

    def nodes_on_edge(self, edge: Tuple[int, int], tol: float = 1e-9) -> np.ndarray:
        """All node indices collinear with the segment through the edge's
        corner vertices. Reference predicate `_get_points_on_edge`
        (fea_analysis.py:183-188) — note it selects collinear nodes anywhere
        on the infinite line, a quirk preserved here (tolerance adapted to
        our subdivision arithmetic)."""
        c0 = self.coords[edge[0]]
        c1 = self.coords[edge[1]]
        d = c1 - c0
        rel = self.coords - c0
        cross = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0])
        return np.where(cross < tol)[0]


_lib = None
_lib_failed = False


def _library_path() -> Optional[str]:
    """`cdt/libfea_cdt-<key>.so`, keyed by everything that shapes the
    binary; None when there is no compiler."""
    try:
        version = subprocess.run(
            [_CXX, "--version"], check=True, capture_output=True, text=True
        ).stdout
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    h = hashlib.sha256()
    with open(_SRC_PATH, "rb") as f:
        h.update(f.read())
    for part in (*_CXX_FLAGS, version, platform.machine()):
        h.update(b"\0" + part.encode())
    return os.path.join(_CDT_DIR, f"libfea_cdt-{h.hexdigest()[:16]}.so")


def _build_library() -> Optional[str]:
    so_path = _library_path()
    if so_path is None:
        return None
    if os.path.exists(so_path):
        return so_path
    # build beside the target and rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [_CXX, *_CXX_FLAGS, _SRC_PATH, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)
        return so_path
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _build_library()
    if so is None:
        _lib_failed = True
        print(
            "WARNING: the native CDT mesher could not be built "
            f"({_CXX} {' '.join(_CXX_FLAGS)} {_SRC_PATH}); meshing falls back "
            "to SciPy Delaunay, whose meshes differ",
            file=sys.stderr,
            flush=True,
        )
        return None
    lib = ctypes.CDLL(so)
    lib.fea_triangulate.restype = ctypes.c_int
    lib.fea_triangulate.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fea_hinge_singular.restype = ctypes.c_int
    lib.fea_hinge_singular.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def native_mesher_loaded() -> bool:
    """True when meshing runs through the native CDT library."""
    return _get_lib() is not None


def hinge_singular(triangles, fixed_mask) -> Optional[bool]:
    """Articulation-point mechanism check on the stiff edge graph
    (cdt.cpp fea_hinge_singular): True if some cut vertex separates a
    sub-body carrying no Dirichlet-fixed node (zero-energy rotation
    about the hinge). Returns None when the native library is
    unavailable (callers fall back to letting the solver discover it)."""
    lib = _get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    fixed = np.ascontiguousarray(fixed_mask, dtype=np.uint8)
    m = len(tris)
    n = len(fixed)
    if m == 0:
        return True
    rc = lib.fea_hinge_singular(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(m),
        ctypes.c_int(n),
        fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return None if rc < 0 else bool(rc)


def _boundary_scaffold(
    exterior: np.ndarray, holes: List[np.ndarray]
) -> Tuple[List[np.ndarray], List[List[Tuple[int, int]]]]:
    ring_corner_ids: List[np.ndarray] = []
    ring_edges: List[List[Tuple[int, int]]] = []
    base = 0
    for ring in [exterior] + list(holes):
        m = len(ring)
        ids = np.arange(base, base + m, dtype=np.int64)
        ring_corner_ids.append(ids)
        ring_edges.append(
            [(int(ids[i]), int(ids[(i + 1) % m])) for i in range(m)]
        )
        base += m
    return ring_corner_ids, ring_edges


def triangulate(
    exterior: np.ndarray,
    holes: Optional[List[np.ndarray]] = None,
    mesh_size: float = 1e-2,
    max_nodes: int = 262144,
    max_triangles: int = 524288,
) -> Mesh:
    """Mesh a polygon-with-holes at target edge length `mesh_size`."""
    holes = holes or []
    lib = _get_lib()
    if lib is None:
        return _triangulate_fallback(exterior, holes, mesh_size)

    ext = np.ascontiguousarray(exterior, dtype=np.float64)
    hole_arr = (
        np.concatenate([np.ascontiguousarray(h, dtype=np.float64) for h in holes])
        if holes
        else np.zeros((0, 2))
    )
    hole_sizes = np.array([len(h) for h in holes], dtype=np.int32)

    out_coords = np.empty((max_nodes, 2), dtype=np.float64)
    out_tris = np.empty((max_triangles, 3), dtype=np.int32)
    n_nodes = ctypes.c_int(0)
    n_tris = ctypes.c_int(0)

    def cptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = lib.fea_triangulate(
        cptr(ext, ctypes.c_double),
        len(ext),
        cptr(hole_arr, ctypes.c_double),
        cptr(hole_sizes, ctypes.c_int),
        len(holes),
        float(mesh_size),
        cptr(out_coords, ctypes.c_double),
        max_nodes,
        cptr(out_tris, ctypes.c_int),
        max_triangles,
        ctypes.byref(n_nodes),
        ctypes.byref(n_tris),
    )
    if rc != 0:
        raise MeshError(f"fea_triangulate failed with code {rc}")

    ring_corner_ids, ring_edges = _boundary_scaffold(ext, holes)
    return Mesh(
        coords=out_coords[: n_nodes.value].copy(),
        triangles=out_tris[: n_tris.value].copy(),
        ring_corner_ids=ring_corner_ids,
        ring_edges=ring_edges,
    )


def triangulate_polygon(polygon: Polygon, mesh_size: float = 1e-2, **kw) -> Mesh:
    return triangulate(polygon.exterior, list(polygon.holes), mesh_size, **kw)


def _triangulate_fallback(
    exterior: np.ndarray, holes: List[np.ndarray], mesh_size: float
) -> Mesh:
    """SciPy-based fallback with the same point strategy and contracts."""
    from scipy.spatial import Delaunay  # test/CI environments only

    rings = [np.asarray(exterior, float)] + [np.asarray(h, float) for h in holes]
    nodes: List[np.ndarray] = [r for r in rings]  # corners first
    corner_pts = np.concatenate(nodes)
    pts = [corner_pts]

    bsegs = []
    base = 0
    extra: List[np.ndarray] = []
    next_id = sum(len(r) for r in rings)
    for r in rings:
        m = len(r)
        for i in range(m):
            a, b = r[i], r[(i + 1) % m]
            nseg = max(1, int(np.ceil(np.hypot(*(b - a)) / mesh_size - 1e-9)))
            prev = base + i
            for s in range(1, nseg):
                extra.append(a + (s / nseg) * (b - a))
                bsegs.append((prev, next_id))
                prev = next_id
                next_id += 1
            bsegs.append((prev, base + (i + 1) % m))
        base += m
    if extra:
        pts.append(np.array(extra))

    minx, miny = exterior.min(axis=0)
    maxx, maxy = exterior.max(axis=0)
    h = mesh_size
    row_h = h * np.sqrt(3) / 2
    ys = np.arange(miny + 0.75 * row_h, maxy, row_h)
    interior = []
    poly = Polygon(exterior=np.asarray(exterior, float), holes=list(holes))
    for row, y in enumerate(ys):
        xs = np.arange(minx + (0.75 * h if row % 2 else 0.25 * h), maxx, h)
        cand = np.stack([xs, np.full_like(xs, y)], axis=1)
        rng = np.random.default_rng(row)
        cand = cand + 1e-4 * h * (rng.random(cand.shape) - 0.5)
        mask = poly.contains_points(cand)
        # clearance from boundary segments
        for r in rings:
            m = len(r)
            a = r
            b = np.roll(r, -1, axis=0)
            d = b - a
            l2 = (d**2).sum(axis=1)
            ap = cand[:, None, :] - a[None, :, :]
            t = np.clip((ap * d[None]).sum(-1) / np.maximum(l2[None], 1e-30), 0, 1)
            closest = a[None] + t[..., None] * d[None]
            dist = np.linalg.norm(cand[:, None, :] - closest, axis=-1).min(axis=1)
            mask &= dist >= 0.6 * h
        interior.append(cand[mask])
    if interior:
        pts.append(np.concatenate(interior))

    coords = np.concatenate(pts)
    tri = Delaunay(coords)
    cents = coords[tri.simplices].mean(axis=1)
    keep = poly.contains_points(cents)
    triangles = tri.simplices[keep].astype(np.int32)

    mesh_edges = set()
    for t in triangles:
        for e in range(3):
            a, b = int(t[e]), int(t[(e + 1) % 3])
            mesh_edges.add((min(a, b), max(a, b)))
    for a, b in bsegs:
        if (min(a, b), max(a, b)) not in mesh_edges:
            raise MeshError("fallback triangulation is not boundary-conforming")

    ring_corner_ids, ring_edges = _boundary_scaffold(exterior, holes)
    return Mesh(
        coords=coords,
        triangles=triangles,
        ring_corner_ids=ring_corner_ids,
        ring_edges=ring_edges,
    )
