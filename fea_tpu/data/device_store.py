"""Device-resident condition store: batches assembled in device memory
from indices.

The per-step batch upload is ~19-33 MB at 256px/b16 even with transfer
packing. Data residency removes it: upload the store's packed uint8/int8
tables ONCE (~6.5 GB for the 4,000-plate production store: the {0,1}
geometry and constraint masks are bitpacked 8 px/byte, saving ~1.15 GB
vs flat uint8, and unpacked on-device with two shift ops per batch), and
assemble each batch inside the jitted train step from three small int32
index vectors (~100 bytes/step on the wire).

Memory budget: the resident tables share device memory with the train
step's temporaries and params/optimizer/EMA. Micro-batching
(--batch_size 8 --num_gradient_accumulation_steps 2) halves the
temporaries when they do not fit together.

Assembly reproduces `StoredFEADataset.__getitem__` (store.py:385)
bit-exactly:

* masks decode as `2*u8 - 1` (to_signed of exact {0,1} masks),
* displacement through a 256-entry table of `2*(1 - k/255) - 1`
  computed on the host by the store's own f32 expression (a compiler may
  contract or reorder that expression, which moves half the values by an
  ulp),
* per-step force log-norms and range decompositions are precomputed on
  the HOST in the same f64-then-f32 pipeline the store uses (the store
  computes them per sample; per (condition, step) they are a tiny
  table: (P*C, steps, R+1, 2) ~60 MB), so the device does pure gathers.

Reference counterpart: none — the reference re-decodes PNGs through a
num_workers=0 DataLoader every epoch (model/diffusion.py:105-380,
514-527). This module is the fused datagen->training data path SURVEY.md
§1 calls the north star.
"""

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .store import StoredFEADataset, to_signed

# Per-device budget for resident tables; leaves room for
# params/optimizer/EMA (~1.7 GB at input_dim 64) and activations.
# FEA_TPU_DEVICE_STORE_CAP overrides it.
DEFAULT_TABLE_BYTE_CAP = 11 * 1024**3


def estimate_table_bytes(ds: StoredFEADataset) -> int:
    n_steps = ds.num_steps
    fnorm = ds.force_vals.shape[0] * n_steps * (ds.force_vals.shape[1] + 1) * 2 * 4
    ranges = ds.ranges.shape[0] * n_steps * 4 * 4 * 3
    # {0,1} masks ride bitpacked (8 px/byte) when the row length allows
    mask_div = 8 if ds.image_size % 8 == 0 else 1
    return int(
        ds.geometry.nbytes // mask_div
        + ds.constraints.nbytes // mask_div
        + ds.displacement.nbytes
        + ds.force_winner.nbytes
        + ds.mat_winner.nbytes
        + ds.mat_norm.nbytes
        + fnorm
        + ranges
        + 256 * 4  # displacement_lut
    )


def _unpack_mask_bits(packed: jax.Array) -> jax.Array:
    """(..., S//8) uint8 -> (..., S) uint8 of {0,1}, np.packbits order.

    np.packbits is bitorder='big': element j of each 8-group lands in bit
    7-j, so shifting by [7..0] restores element order. Two VPU ops per
    batch — negligible beside the conv stack.
    """
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def build_device_tables(
    ds: StoredFEADataset, sharding=None
) -> Dict[str, jax.Array]:
    """Precompute host-side scalar tables and upload everything once.

    `sharding` should replicate across the DP mesh (tables are read-only;
    each device gathers its own batch shard locally — no collectives).
    """
    nc, r, _ = ds.force_vals.shape
    assert r + 1 <= 127 and ds.mat_norm.shape[1] <= 127, (
        "winner+1 must fit int8"
    )
    n_steps = ds.num_steps
    # Per-(condition, step) force log-norms, f64 scalar pipeline then f32
    # cast — the exact math of store.py __getitem__ (which mirrors the
    # reference's Python-float pipeline, diffusion.py:246-266).
    v = ds.force_vals[:, None, :, :]  # (NC, 1, R, 2) f64
    steps = np.arange(1, n_steps + 1, dtype=np.float64)[None, :, None, None]
    norm = np.sign(v) * np.log(np.abs(v) * (steps - 1) / n_steps + 1.0)
    fnorm = np.zeros((nc, n_steps, r + 1, 2), np.float32)
    fnorm[:, :, 1:, :] = norm
    rng = ds.ranges[:, :n_steps].astype(np.float32)  # (NC, steps, 4)

    host_tables = {
        "displacement": np.asarray(ds.displacement),  # (NC, S, S, 2) uint8
        # gray level k -> field value, exactly as store.py decodes it
        "displacement_lut": to_signed(
            1.0 - np.arange(256, dtype=np.float32) / 255.0
        ),
        # winner+1 so slot 0 is "no region" (value 0.0 in the norm
        # tables); stays int8 — winners are -1..R-1 with R <= 96, so +1
        # fits and the two 2.1 GB tables don't double to int16
        "force_winner": np.asarray(ds.force_winner) + np.int8(1),
        "mat_winner": np.asarray(ds.mat_winner) + np.int8(1),
        "fnorm": fnorm,
        "mat_norm": ds.mat_norm,  # (NC, R+1, 2) f32, slot 0 = 0
        "ranges": rng,
        "log_ranges": np.log1p(np.abs(rng)).astype(np.float32),
        "sign_ranges": (rng >= 0).astype(np.float32),
    }
    geometry = np.asarray(ds.geometry)  # (P, S, S) uint8 of {0,1}
    constraints = np.asarray(ds.constraints)  # (NC, S, S) uint8 of {0,1}
    if ds.image_size % 8 == 0:
        # bitpack the binary masks 8 px/byte (saves ~1.15 GB of HBM on
        # the 4,000-plate production store; the masks are exact {0,1} by
        # the store's _binarize contract, store.py:189). packbits treats
        # any nonzero as 1, so the round-trip is exact for {0,1} input.
        host_tables["geometry_bits"] = np.packbits(geometry, axis=-1)
        host_tables["constraints_bits"] = np.packbits(constraints, axis=-1)
    else:
        host_tables["geometry"] = geometry
        host_tables["constraints"] = constraints
    put = (
        (lambda x: jax.device_put(x, sharding))
        if sharding is not None
        else jax.device_put
    )
    return {k: put(v) for k, v in host_tables.items()}


def index_arrays(
    ds: StoredFEADataset, indices: np.ndarray
) -> Dict[str, np.ndarray]:
    """Host side: sample indices -> (plate row, condition row, step-1)."""
    indices = np.asarray(indices, np.int64)
    plate_row = indices // ds.samples_per_plate
    rem = indices % ds.samples_per_plate
    cond_row = plate_row * ds.C + rem // ds.num_steps
    step0 = rem % ds.num_steps  # 0-based; sample step = step0 + 1
    return {
        "pi": plate_row.astype(np.int32),
        "ci": cond_row.astype(np.int32),
        "si": step0.astype(np.int32),
        # sample metadata (kept for parity with dataset samples)
        "plate_index": (plate_row + ds.start_plate_index).astype(np.int32),
        "condition_index": (rem // ds.num_steps + 1).astype(np.int32),
        "iteration_index": (step0 + 1).astype(np.int32),
    }


def assemble_batch(
    tables: Dict[str, jax.Array], idx: Dict[str, jax.Array]
) -> Dict[str, jax.Array]:
    """jit-safe device assembly of one (micro-)batch from index vectors.

    Output matches `StoredFEADataset.__getitem__` leaves bit-exactly
    (asserted by tests/test_device_store.py), already in the unpacked
    f32 form `Trainer._unpack_transfer` produces.
    """
    pi, ci, si = idx["pi"], idx["ci"], idx["si"]

    def signed(u8):
        return u8.astype(jnp.float32) * 2.0 - 1.0

    if "geometry_bits" in tables:  # static: pytree structure
        g = _unpack_mask_bits(tables["geometry_bits"][pi])  # (B, S, S)
        c = _unpack_mask_bits(tables["constraints_bits"][ci])
    else:
        g = tables["geometry"][pi]  # (B, S, S) uint8
        c = tables["constraints"][ci]
    k = tables["displacement"][ci].astype(jnp.int32)  # (B, S, S, 2)

    fn = tables["fnorm"][ci, si]  # (B, R+1, 2) f32
    fw = tables["force_winner"][ci].astype(jnp.int32)  # (B, S, S, 2)
    forces = jnp.stack(
        [
            jax.vmap(lambda t, w: t[w])(fn[:, :, 0], fw[:, :, :, 0]),
            jax.vmap(lambda t, w: t[w])(fn[:, :, 1], fw[:, :, :, 1]),
        ],
        axis=-1,
    )
    mn = tables["mat_norm"][ci]  # (B, R+1, 2)
    mw = tables["mat_winner"][ci].astype(jnp.int32)
    materials = jnp.stack(
        [
            jax.vmap(lambda t, w: t[w])(mn[:, :, 0], mw[:, :, :, 0]),
            jax.vmap(lambda t, w: t[w])(mn[:, :, 1], mw[:, :, :, 1]),
        ],
        axis=-1,
    )

    return {
        "plate_index": idx["plate_index"],
        "condition_index": idx["condition_index"],
        "iteration_index": idx["iteration_index"],
        "geometry": signed(g)[..., None],
        "displacement": tables["displacement_lut"][k],
        "constraints": signed(c)[..., None],
        "forces": forces,
        "materials": materials,
        "displacement_range": tables["ranges"][ci, si],
        "log_displacement_range": tables["log_ranges"][ci, si],
        "sign_displacement_range": tables["sign_ranges"][ci, si],
    }
