"""End-to-end application workflow.

The CLI equivalent of the reference's notebook pipeline
(test_nbs/generateapplication.ipynb): solve the application problem,
render outline / geometry / constraint / force / displacement images
(displacement at the fixed +-0.05 decode scale the metrics assume),
optionally run a trained FDN-UNet surrogate on the rendered inputs, and
score the prediction against the ground-truth solve.
"""

import os
from typing import Dict, Optional

import numpy as np

from ..fem import StaticProblem
from ..fem.problem import solve_refined
from ..datagen.pipeline import next_bucket
from ..datagen.writers import append_region_value, save_gray_png, verify_directory
from ..mesh import Mesh, read_medit_mesh, triangulate, write_vtk
from ..metrics.accuracy import accuracy_for_one_sample
from ..raster import (
    build_pixel_map,
    field_image,
    geometry_image,
    node_splat_image,
    outline_image,
    scalar_range,
)
from .specs import APPLICATIONS, ApplicationSpec


def _facet_nodes(coords, triangles, candidate_mask):
    """sfepy facet-region rule: vertices of triangle edges whose endpoints
    both satisfy the predicate."""
    tri = np.asarray(triangles)
    keep = np.zeros(len(coords), dtype=bool)
    for e in range(3):
        a = tri[:, e]
        b = tri[:, (e + 1) % 3]
        both = candidate_mask[a] & candidate_mask[b]
        keep[a[both]] = True
        keep[b[both]] = True
    return keep


def _nearest_node(coords, point, tol=1e-6):
    d = np.linalg.norm(coords - np.asarray(point), axis=1)
    idx = int(d.argmin())
    assert d[idx] < max(tol, 1e-3), f"no node near {point} (closest {d[idx]:.2e})"
    return idx


def _collinear_nodes(coords, p0, p1, tol=1e-9):
    p0 = np.asarray(p0)
    p1 = np.asarray(p1)
    d = p1 - p0
    rel = coords - p0
    cross = np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0])
    return np.where(cross < tol)[0]


def build_problem(spec: ApplicationSpec, mesh: Mesh) -> StaticProblem:
    coords = mesh.coords
    sign = -1.0 if spec.negate_loads else 1.0

    fixed = np.zeros(mesh.num_nodes, dtype=bool)
    for pred in spec.constraint_predicates:
        fixed |= _facet_nodes(coords, mesh.triangles, pred(coords))
    for v in spec.constraint_vertices:
        fixed[_nearest_node(coords, v)] = True

    loads = np.zeros((mesh.num_nodes, 2))
    for load in spec.loads:
        val = sign * np.asarray(load.value)
        if load.vertex is not None:
            loads[_nearest_node(coords, load.vertex)] += val
        elif load.predicate is not None:
            nodes = np.where(
                _facet_nodes(coords, mesh.triangles, load.predicate(coords))
            )[0]
            loads[nodes] += val  # dw_point_load: value at every region vertex
        elif load.collinear is not None:
            nodes = _collinear_nodes(coords, *load.collinear)
            loads[nodes] += val

    if spec.material_regions is not None:
        from ..fem.problem import element_materials

        regions = [
            ((m.young, m.poisson), np.where(m.predicate(coords))[0])
            for m in spec.material_regions
        ]
        young, poisson = element_materials(mesh.triangles, mesh.num_nodes, regions)
    else:
        young = np.full(mesh.num_triangles, spec.young)
        poisson = np.full(mesh.num_triangles, spec.poisson)

    return StaticProblem(
        coords=np.asarray(coords),
        triangles=np.asarray(mesh.triangles),
        young=young,
        poisson=poisson,
        fixed_nodes=fixed,
        loads=loads,
        num_steps=spec.num_steps,
    )


def load_app_mesh(spec: ApplicationSpec) -> Mesh:
    if spec.mesh_fixture and os.path.isfile(spec.mesh_fixture):
        coords, tris = read_medit_mesh(spec.mesh_fixture)
        return Mesh(coords=coords, triangles=tris)
    return triangulate(spec.polygon, mesh_size=spec.mesh_size)


def run_application(
    name: str,
    output_dir: str = "app_output",
    image_size: int = 512,
    checkpoint: Optional[str] = None,
    decode_scale: float = 0.05,
    use_ema: bool = False,
) -> Dict:
    spec = APPLICATIONS[name]
    verify_directory(output_dir)

    mesh = load_app_mesh(spec)
    problem = build_problem(spec, mesh)
    result = solve_refined(
        problem,
        pad_buckets=(
            next_bucket(mesh.num_nodes + 3),
            next_bucket(mesh.num_triangles),
        ),
    )
    u = np.asarray(result.displacements[-1])

    # ---- renders (same framing/colormap semantics as datagen) -----------
    pixel_map = build_pixel_map(mesh.coords, mesh.triangles, image_size)
    save_gray_png(
        os.path.join(output_dir, "geometry.png"), geometry_image(pixel_map)
    )
    if mesh.ring_corner_ids:
        save_gray_png(
            os.path.join(output_dir, "outline.png"),
            outline_image(pixel_map, mesh.coords, mesh.ring_corner_ids),
        )
    save_gray_png(
        os.path.join(output_dir, "constraint.png"),
        node_splat_image(
            pixel_map, mesh.coords, np.where(problem.fixed_nodes)[0]
        ),
    )
    save_gray_png(
        os.path.join(output_dir, "force.png"),
        node_splat_image(
            pixel_map,
            mesh.coords,
            np.where((problem.loads != 0).any(axis=1))[0],
        ),
    )
    for axis, channel in (("x", 0), ("y", 1)):
        save_gray_png(
            os.path.join(output_dir, f"displacement_{axis}.png"),
            field_image(
                pixel_map,
                mesh.triangles,
                u[:, channel],
                value_range=(-decode_scale, decode_scale),
            ),
        )
        lo, hi = scalar_range(u[:, channel])
        append_region_value(
            os.path.join(output_dir, "ranges.txt"),
            f"displacement_{axis}_1",
            (lo, hi),
        )

    vtk_path = os.path.join(output_dir, f"{name}.vtk")
    write_vtk(vtk_path, mesh.coords, mesh.triangles, point_data={"u": u})

    out: Dict = {
        "name": name,
        "nodes": mesh.num_nodes,
        "triangles": mesh.num_triangles,
        "residual_norm": float(result.residual_norm),
        "converged": bool(result.converged),
        "u_min": float(u.min()),
        "u_max": float(u.max()),
        "vtk": vtk_path,
    }

    # ---- ground-truth self-consistency: rasterize -> metrics sampler ----
    gt_metrics = accuracy_for_one_sample(
        vtk_path,
        os.path.join(output_dir, "displacement_x.png"),
        os.path.join(output_dir, "displacement_y.png"),
        os.path.join(output_dir, "geometry.png"),
        image_size=image_size,
        clip=decode_scale,
    )
    out["raster_roundtrip_mae"] = gt_metrics[0]

    # ---- optional surrogate prediction -----------------------------------
    if checkpoint is not None:
        pred_metrics = predict_with_surrogate(
            spec, mesh, problem, output_dir, image_size, checkpoint,
            decode_scale, use_ema=use_ema,
        )
        out.update(pred_metrics)
    return out


def predict_with_surrogate(
    spec, mesh, problem, output_dir, image_size, checkpoint, decode_scale,
    use_ema: bool = False,
) -> Dict:
    """Run a trained FDN-UNet on the app's rendered inputs
    (generateapplication.ipynb cells 8-18) and score it."""
    import time

    import jax.numpy as jnp

    t_start = time.perf_counter()

    from ..data.dataset import to_signed
    from ..train.trainer import TrainerConfig

    # Build model inputs with the dataset normalization contract.
    model_size = 256
    pm = build_pixel_map(mesh.coords, mesh.triangles, model_size)
    geometry01 = (geometry_image(pm) < 128).astype(np.float32)

    constraints01 = (
        node_splat_image(pm, mesh.coords, np.where(problem.fixed_nodes)[0])
        < 128
    ).astype(np.float32)

    forces = np.zeros((model_size, model_size, 2), np.float32)
    loaded = np.where((problem.loads != 0).any(axis=1))[0]
    for node in loaded:
        mask = (
            node_splat_image(pm, mesh.coords, np.array([node])) < 128
        ).astype(np.float32)
        mag = problem.loads[node]
        norm = np.sign(mag) * np.log1p(np.abs(mag))
        layer = np.stack([mask * norm[0], mask * norm[1]], axis=-1)
        forces = np.where(layer != 0, layer, forces)

    young_vals = np.zeros(mesh.num_nodes)
    poisson_vals = np.zeros(mesh.num_nodes)
    if spec.material_regions is not None:
        for m in spec.material_regions:
            sel = m.predicate(mesh.coords)
            young_vals[sel] = m.young
            poisson_vals[sel] = m.poisson
    else:
        young_vals[:] = spec.young
        poisson_vals[:] = spec.poisson
    from ..raster.rasterizer import interpolate_field

    young_img = np.asarray(
        interpolate_field(pm, mesh.triangles, np.log1p(young_vals))
    )
    poisson_img = np.asarray(
        interpolate_field(pm, mesh.triangles, poisson_vals)
    )
    materials = np.stack(
        [young_img * geometry01, poisson_img * geometry01], axis=-1
    ).astype(np.float32)

    batch = {
        "materials": materials[None],
        "forces": forces[None],
        "constraints": to_signed(constraints01)[None, ..., None],
        "geometry": to_signed(geometry01)[None, ..., None],
    }

    from ..models import create_models
    from ..train.checkpoint import load_flat, unflatten

    restored = unflatten(load_flat(checkpoint, ("params/", "ema_params/")))
    # EMA weights option: the reference notebooks load checkpoints into an
    # ema_pytorch.EMA wrapper (generateapplication.ipynb cell 16)
    params = restored["params"]
    if use_ema:
        ema = restored.get("ema_params")
        assert ema is not None, (
            "use_ema requested but the checkpoint holds no EMA weights "
            "(train with --use_ema_model)"
        )
        params = ema
    config = TrainerConfig()
    # the model width is the checkpoint's: its initial conv's output width
    input_dim = params["encoder"]["initial_conv"]["kernel"].shape[-1]
    encoder, decoder, _auxiliary = create_models(
        input_dim=input_dim,
        image_height=model_size,
        image_width=model_size,
        num_channels=config.num_channels,
        num_auxiliary_condition_channels=config.num_auxiliary_condition_channels,
        num_stages=config.num_stages,
    )

    t_weights = time.perf_counter()
    conditions = jnp.concatenate(
        [jnp.asarray(batch["forces"]), jnp.asarray(batch["constraints"])],
        axis=-1,
    )
    x, hidden, residual = encoder.apply(
        {"params": params["encoder"]}, jnp.asarray(batch["materials"]), conditions
    )
    image = decoder.apply(
        {"params": params["decoder"]}, x, list(hidden), residual
    )
    geometry = jnp.asarray(batch["geometry"])
    image = ((image + 1.0) / 2.0 * (geometry + 1.0) / 2.0) * 2.0 - 1.0
    image = np.asarray(image)[0]
    t_predicted = time.perf_counter()

    for axis, ch in (("x", 0), ("y", 1)):
        img = np.round((1.0 - (image[:, :, ch] + 1.0) / 2.0) * 255).astype(
            np.uint8
        )
        save_gray_png(
            os.path.join(output_dir, f"predicted_displacement_{axis}.png"), img
        )

    mae, mse, rmse = accuracy_for_one_sample(
        os.path.join(output_dir, f"{spec.name}.vtk"),
        os.path.join(output_dir, "predicted_displacement_x.png"),
        os.path.join(output_dir, "predicted_displacement_y.png"),
        os.path.join(output_dir, "geometry.png"),
        image_size=model_size,
        clip=decode_scale,
    )

    # Write predictions back onto the mesh as a VTK (the reference's
    # save_pred_disp_mesh notebook, test_nbs/save_pred_disp_mesh.ipynb).
    from ..metrics.accuracy import predicted_displacement_at_nodes

    pred_nodes = predicted_displacement_at_nodes(
        mesh.coords,
        os.path.join(output_dir, "predicted_displacement_x.png"),
        os.path.join(output_dir, "predicted_displacement_y.png"),
        os.path.join(output_dir, "geometry.png"),
        image_size=model_size,
        decode_scale=decode_scale,
    )
    write_vtk(
        os.path.join(output_dir, "predicted.vtk"),
        mesh.coords,
        mesh.triangles,
        point_data={"u": pred_nodes},
    )
    t_end = time.perf_counter()
    return {
        "pred_mae": mae,
        "pred_mse": mse,
        "pred_rmse": rmse,
        # end-to-end serve timing: rendering the model inputs from the
        # mesh, checkpoint restore, forward (incl. one-time jit compile
        # + the fetch), PNG decode + scoring + VTK writeback
        "predict_wall_s": {
            "render_inputs_and_restore": round(t_weights - t_start, 2),
            "forward_incl_compile_and_fetch": round(
                t_predicted - t_weights, 2
            ),
            "decode_score_writeback": round(t_end - t_predicted, 2),
            "total": round(t_end - t_start, 2),
        },
    }
