"""Training runtime for the FDN-UNet surrogate.

The reference Trainer (model/diffusion.py:418-1128) drives three torch
modules with separate Adam optimizers under HF Accelerate DDP. Here the
whole step — grad accumulation (lax.scan), per-module clip-by-global-norm
1.0, three Adam chains, EMA — is one jitted SPMD program over a 'dp'
device mesh; gradients all-reduce via the psum XLA inserts for the
sharded batch axis.

Semantics preserved:
  * summed mean-L1/L2 losses over the active heads (diffusion.py:722-751)
  * geometry masking of the image prediction (diffusion.py:816-820)
  * disable_auxiliary / only_auxiliary gating (diffusion.py:464-469)
  * effective-batch >= 16 and dataset-size >= 100 guards
  * milestone / soft-milestone loop with best/latest(+prev) checkpoint
    rotation and 'final' save (diffusion.py:1080-1127)
  * resume with deterministic data skip-ahead (O(1) — see EpochSampler)
  * results/train-e{steps}-b{batch}-lr{lr}-{ts}.log logging
"""

import dataclasses
import logging
import os
import shutil
import zipfile
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..data.dataset import EpochSampler, FEADataset, collate
from ..models import create_models
from ..parallel.distributed import (
    ensure_initialized,
    is_main_process,
    sync_processes,
)
from ..parallel.mesh import (
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from ..utils.png import write_png
from ..utils.progress import progress
from . import checkpoint
from .ema import ema_update


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrainState:
    params: Dict[str, Any]
    opt_states: Dict[str, Any]
    ema_params: Optional[Dict[str, Any]]
    step: jnp.ndarray
    lowest_sample_loss: jnp.ndarray

    replace = dataclasses.replace


@dataclass
class TrainerConfig:
    dataset_folder: str = "data"
    sample_dataset_folder: str = "sample_data"
    disable_auxiliary: bool = True
    only_auxiliary: bool = False
    dataset_image_size: int = 256
    train_batch_size: int = 16
    sample_batch_size: Optional[int] = None
    train_start_plate_index: int = 1
    sample_start_plate_index: int = 1
    conditions_per_plate: int = 4
    num_sample_conditions_per_plate: int = 1
    num_steps_per_condition: int = 6
    num_steps_per_sample_condition: int = 6
    num_gradient_accumulation_steps: int = 1
    train_learning_rate: float = 1e-4
    num_train_steps: int = 1000
    num_steps_per_milestone: int = 250
    num_steps_per_soft_milestone: int = 50
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    max_gradient_norm: float = 1.0
    loss_type: str = "l1"
    use_ema: bool = False
    ema_decay: float = 0.995
    results_folder: str = "results"
    input_dim: int = 64
    num_stages: int = 4
    num_channels: int = 2  # displacement / materials channels
    num_auxiliary_condition_channels: int = 3  # forces (2) + constraints (1)
    seed: int = 0
    progress_bar: bool = True
    # keep decoded samples in RAM (~2 MB/sample at 256px) — the PNG
    # decode pipeline is the host-side bottleneck on few-core hosts.
    # None = auto: cache when the whole dataset fits comfortably
    # (<= 20k samples, ~40 GB at 256px); True/False force it.
    cache_datasets: Optional[bool] = None
    # decoded-on-disk condition store (fea_tpu.data.store): feeds
    # production-scale datasets at device speed where the RAM cache
    # cannot hold them. Build with `fea_tpu store`.
    dataset_store: Optional[str] = None
    n_devices: Optional[int] = None
    skip_dataset_size_check: bool = False
    inference_only: bool = False  # sampling CLI: no effective-batch floor
    param_dtype: Any = jnp.float32
    # Mixed precision: 'bfloat16' runs the UNet compute (convs on the
    # tensor cores) in bf16 with f32 master weights — params and inputs are cast
    # at apply time, outputs cast back, so Adam/EMA/loss stay f32.
    # bf16 shares f32's exponent range, so no loss scaling is needed.
    # None = full f32 (the reference trains f32, model/diffusion.py).
    compute_dtype: Optional[str] = None
    # Bit-exact host->device transfer packing (see _pack_transfer):
    # ±1 mask channels ship as int8; with bf16 compute, forces/materials
    # ship pre-cast to bf16. Only affects bytes on the wire.
    pack_transfers: bool = True
    # Device-resident store (requires dataset_store): upload the packed
    # condition tables to HBM once and assemble batches inside the
    # jitted train step from index vectors — ~100 bytes/step of host
    # traffic instead of ~19-33 MB (data/device_store.py). Bit-exact vs
    # the host feed. Auto-falls back if tables exceed the HBM cap.
    device_resident_store: bool = False
    # Rematerialize the forward pass during backward (jax.checkpoint on
    # the per-micro-batch loss): trades ~1/3 more FLOPs for near-zero
    # stored activations — the escape hatch when resident tables +
    # activations crowd HBM.
    remat_loss: bool = False


class Trainer:
    def __init__(self, config: TrainerConfig, dataset=None, sample_dataset=None):
        """`dataset` / `sample_dataset` override the folder-backed
        FEADataset with any compatible dataset (e.g. the in-memory fused
        pipeline, fea_tpu.data.arrays.InMemoryFEADataset)."""
        assert not (config.disable_auxiliary and config.only_auxiliary), (
            "Cannot disable and only use auxiliary"
        )
        assert config.num_steps_per_condition >= 2
        assert config.num_steps_per_sample_condition >= 2
        assert config.inference_only or (
            config.train_batch_size * config.num_gradient_accumulation_steps >= 16
        ), "effective batch size (batch x grad accum) must be at least 16"
        assert config.loss_type in ("l1", "l2")
        self.device_tables = None
        self.config = config

        # Multi-controller runtime (no-op single-process): join the
        # cluster before the first backend query, then gate every
        # host-side effect below on the main process — the reference's
        # accelerator.is_main_process contract (diffusion.py:613).
        ensure_initialized()
        self.is_main = is_main_process()
        self.mesh = make_mesh(config.n_devices)
        self.n_devices = self.mesh.devices.size
        assert config.train_batch_size % self.n_devices == 0, (
            f"batch size {config.train_batch_size} must divide over "
            f"{self.n_devices} devices"
        )

        # Datasets
        if dataset is None and config.dataset_store is not None:
            from ..data.store import StoredFEADataset

            dataset = StoredFEADataset(
                config.dataset_store,
                start_plate_index=config.train_start_plate_index,
            )
            assert dataset.image_size == config.dataset_image_size
            assert dataset.num_steps == config.num_steps_per_condition - 1
            assert (
                dataset.conditions_per_plate_geometry
                == config.conditions_per_plate
            )
            self.dataset = dataset
            if config.device_resident_store:
                from ..data.device_store import (
                    DEFAULT_TABLE_BYTE_CAP,
                    build_device_tables,
                    estimate_table_bytes,
                )

                est = estimate_table_bytes(dataset)
                cap = int(
                    os.environ.get(
                        "FEA_TPU_DEVICE_STORE_CAP", DEFAULT_TABLE_BYTE_CAP
                    )
                )
                if est <= cap:
                    self.device_tables = build_device_tables(
                        dataset, sharding=replicated_sharding(self.mesh)
                    )
                    print(
                        f"device-resident store: {est / 1e9:.2f} GB of "
                        "tables uploaded once; per-step host traffic is "
                        "index vectors only"
                    )
                else:
                    print(
                        f"device-resident store disabled: tables "
                        f"{est / 1e9:.2f} GB exceed cap {cap / 1e9:.2f} GB"
                        " — falling back to the host feed"
                    )
        else:
            self.dataset = dataset if dataset is not None else FEADataset(
                config.dataset_folder,
                image_size=config.dataset_image_size,
                conditions_per_plate=config.conditions_per_plate,
                num_steps=config.num_steps_per_condition,
                start_plate_index=config.train_start_plate_index,
            )
        if dataset is None:
            cache = config.cache_datasets
            if cache is None:
                # auto: cache only when the whole decoded set fits in a
                # fraction of currently-available RAM (a sample is 8
                # float32 channels at S^2: ~2 MB at 256px). Byte-based,
                # not count-based — the old 20k-sample threshold meant
                # ~40 GB regardless of what the host actually had free,
                # compounding the device-plugin leak's OOM kills.
                S = config.dataset_image_size
                est_bytes = len(self.dataset) * (S * S * 8 * 4 + 4096)
                try:
                    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf(
                        "SC_PAGE_SIZE"
                    )
                except (ValueError, OSError):
                    avail = 8 << 30
                cache = est_bytes < 0.25 * avail
            if cache:
                self.dataset._cache = {}
        # The sample set is re-decoded at EVERY soft milestone; always
        # cache it (it is small: milestones would otherwise pay
        # n_samples x ~8 PNG decodes each, serialized on the host core).
        self.sample_dataset = (
            sample_dataset
            if sample_dataset is not None
            else FEADataset(
                config.sample_dataset_folder,
                image_size=config.dataset_image_size,
                conditions_per_plate=config.num_sample_conditions_per_plate,
                num_steps=config.num_steps_per_sample_condition,
                start_plate_index=config.sample_start_plate_index,
                cache_samples=True,
            )
        )
        if not config.skip_dataset_size_check:
            assert len(self.dataset) >= 100, (
                "you should have at least 100 samples; 10k+ recommended"
            )
        self.sampler = EpochSampler(len(self.dataset), seed=config.seed)
        self.sample_batch_size = (
            config.sample_batch_size
            if config.sample_batch_size is not None
            else config.train_batch_size
        )

        # Models
        S = config.dataset_image_size
        self.encoder, self.decoder, self.auxiliary = create_models(
            input_dim=config.input_dim,
            image_height=S,
            image_width=S,
            num_stages=config.num_stages,
            num_channels=config.num_channels,
            num_auxiliary_condition_channels=config.num_auxiliary_condition_channels,
        )

        # resolve(): the checkpoint-zip arcnames are computed with
        # relative_to(results_folder) — a relative results_dir would make
        # that raise mid-training at the first milestone.
        self.results_folder = Path(config.results_folder).resolve()
        self.results_folder.mkdir(parents=True, exist_ok=True)
        log_name = "train-e{}-b{}-lr{}-{}.log".format(
            config.num_train_steps,
            config.train_batch_size,
            str(config.train_learning_rate)[2:],
            datetime.now().strftime("%Y-%m-%d-%H-%M-%S"),
        )
        if self.is_main:
            logging.basicConfig(
                filename=str(self.results_folder / log_name),
                level=logging.INFO,
                format="%(asctime)s %(message)s",
                force=True,
            )
        else:
            # non-main hosts keep the step loop's logging calls cheap
            # and write no train-*.log (reference: log_with only on the
            # main process, diffusion.py:456-458)
            logging.basicConfig(level=logging.ERROR, force=True)

        # Optimizers: clip-by-global-norm 1.0 then Adam, one chain per module.
        def make_opt():
            return optax.chain(
                optax.clip_by_global_norm(config.max_gradient_norm),
                optax.adam(
                    config.train_learning_rate,
                    b1=config.adam_betas[0],
                    b2=config.adam_betas[1],
                ),
            )

        self.optimizers = {k: make_opt() for k in ("encoder", "decoder", "auxiliary")}
        self.state = self._init_state()
        self._train_step = self._build_train_step()
        self._eval_step = self._build_eval_step()

    # ------------------------------------------------------------------ init
    def _init_state(self) -> TrainState:
        cfg = self.config
        S = cfg.dataset_image_size
        rng = jax.random.PRNGKey(cfg.seed)
        k1, k2, k3 = jax.random.split(rng, 3)
        materials = jnp.zeros((1, S, S, cfg.num_channels), cfg.param_dtype)
        conditions = jnp.zeros(
            (1, S, S, cfg.num_auxiliary_condition_channels), cfg.param_dtype
        )
        enc_vars = self.encoder.init(k1, materials, conditions)
        x, hidden, residual = self.encoder.apply(enc_vars, materials, conditions)
        dec_vars = self.decoder.init(k2, x, list(hidden), residual)
        aux_vars = self.auxiliary.init(k3, x)
        params = {
            "encoder": enc_vars["params"],
            "decoder": dec_vars["params"],
            "auxiliary": aux_vars["params"],
        }
        opt_states = {
            k: self.optimizers[k].init(params[k]) for k in self.optimizers
        }
        ema = jax.tree.map(jnp.copy, params) if cfg.use_ema else None
        state = TrainState(
            params=params,
            opt_states=opt_states,
            ema_params=ema,
            step=jnp.zeros((), jnp.int32),
            lowest_sample_loss=jnp.asarray(jnp.inf, jnp.float32),
        )
        return replicate(self.mesh, state)

    def num_params(self) -> Dict[str, int]:
        return {
            k: sum(x.size for x in jax.tree.leaves(v))
            for k, v in self.state.params.items()
        }

    # ------------------------------------------------------------ model fns
    def _apply_model(self, params, batch, use_ema: bool = False):
        """encoder -> (aux heads, decoder) with geometry masking
        (reference sample_model, diffusion.py:786-822).

        With config.compute_dtype='bfloat16', params and image inputs are
        cast to bf16 here (differentiable casts: grads arrive back in
        f32), the UNet runs in bf16, and head outputs are cast
        to f32 before masking/loss. GroupNorm computes its stats in f32
        regardless (models/layers.py), so normalization is unaffected."""
        cfg = self.config
        dt = (
            jnp.dtype(cfg.compute_dtype)
            if cfg.compute_dtype is not None
            else None
        )

        def cast(tree):
            if dt is None:
                return tree
            return jax.tree.map(
                lambda x: x.astype(dt)
                if jnp.issubdtype(x.dtype, jnp.floating)
                else x,
                tree,
            )

        conditions = jnp.concatenate(
            [batch["forces"], batch["constraints"]], axis=-1
        )
        x, hidden, residual = self.encoder.apply(
            {"params": cast(params["encoder"])},
            cast(batch["materials"]),
            cast(conditions),
        )
        image_prediction = None
        range_prediction = None
        if not cfg.disable_auxiliary:
            sign_pred, log_pred = self.auxiliary.apply(
                {"params": cast(params["auxiliary"])}, x
            )
            range_prediction = (
                sign_pred.astype(jnp.float32),
                log_pred.astype(jnp.float32),
            )
        if not cfg.only_auxiliary:
            image_prediction = self.decoder.apply(
                {"params": cast(params["decoder"])}, x, list(hidden), residual
            ).astype(jnp.float32)
            geometry01 = (batch["geometry"] + 1.0) / 2.0
            image_prediction = ((image_prediction + 1.0) / 2.0 * geometry01) * 2.0 - 1.0
        return image_prediction, range_prediction

    def _loss(self, params, batch):
        cfg = self.config
        image_pred, range_pred = self._apply_model(params, batch)

        def head_loss(pred, target):
            if cfg.loss_type == "l1":
                return jnp.mean(jnp.abs(pred - target))
            return jnp.mean((pred - target) ** 2)

        loss = 0.0
        if image_pred is not None:
            loss = loss + head_loss(image_pred, batch["displacement"])
        if range_pred is not None:
            sign_pred, log_pred = range_pred
            loss = loss + head_loss(sign_pred, batch["sign_displacement_range"])
            loss = loss + head_loss(log_pred, batch["log_displacement_range"])
        return loss

    # ------------------------------------------------- transfer packing
    def _pack_transfer(self, batch):
        """Shrink the per-step host->device transfer, bit-exactly.

        An f32 batch is ~33 MB/step at 256px/b16. Two lossless
        reductions:
        geometry/constraint channels are exactly {-1.0, +1.0} (dataset
        contract, data/dataset.py) -> int8; and with compute_dtype
        bfloat16 the model casts forces/materials to bf16 anyway
        (_apply_model), so shipping bf16 gives bit-identical model
        inputs. Displacement (the loss target) and the range heads stay
        f32. 32 -> 18 bytes/pixel."""
        if not self.config.pack_transfers:
            return batch
        out = dict(batch)
        for k in ("geometry", "constraints"):
            if k in out:
                out[k] = out[k].astype(np.int8)
        if self.config.compute_dtype == "bfloat16":
            for k in ("forces", "materials"):
                if k in out:
                    out[k] = out[k].astype(jnp.bfloat16)
        return out

    @staticmethod
    def _unpack_transfer(batch):
        """Device-side inverse of _pack_transfer (idempotent: unpacked
        batches pass through untouched). bf16 channels stay bf16 — the
        model's own cast makes them bf16 regardless; mixed-dtype
        concatenation promotes exactly."""
        out = dict(batch)
        for k in ("geometry", "constraints"):
            if k in out and not jnp.issubdtype(out[k].dtype, jnp.floating):
                out[k] = out[k].astype(jnp.float32)
        return out

    # ---------------------------------------------------------- train step
    def _build_train_step(self):
        cfg = self.config
        optimizers = self.optimizers

        def train_step(state: TrainState, batch, tables=None):
            # batch leaves: (accum, micro, ...) — either packed host
            # tensors or (device-resident mode) index vectors assembled
            # against the HBM-resident tables per micro-batch.
            index_mode = "ci" in batch  # static: pytree structure

            def materialize(micro):
                if index_mode:
                    from ..data.device_store import assemble_batch

                    return assemble_batch(tables, micro)
                return self._unpack_transfer(micro)

            loss_fn = (
                jax.checkpoint(self._loss) if cfg.remat_loss else self._loss
            )

            def accum_body(carry, micro):
                grads_acc, loss_acc = carry
                loss, grads = jax.value_and_grad(loss_fn)(
                    state.params, materialize(micro)
                )
                grads_acc = jax.tree.map(jnp.add, grads_acc, grads)
                return (grads_acc, loss_acc + loss), None

            zero_grads = jax.tree.map(jnp.zeros_like, state.params)
            (grads, loss_sum), _ = jax.lax.scan(
                accum_body, (zero_grads, 0.0), batch
            )
            accum = cfg.num_gradient_accumulation_steps
            grads = jax.tree.map(lambda g: g / accum, grads)
            loss = loss_sum / accum

            new_params = dict(state.params)
            new_opt_states = dict(state.opt_states)
            active = {"encoder": True,
                      "decoder": not cfg.only_auxiliary,
                      "auxiliary": not cfg.disable_auxiliary}
            for key, opt in optimizers.items():
                if not active[key]:
                    continue
                updates, new_opt = opt.update(
                    grads[key], state.opt_states[key], state.params[key]
                )
                new_params[key] = optax.apply_updates(state.params[key], updates)
                new_opt_states[key] = new_opt

            ema = state.ema_params
            if ema is not None:
                ema = ema_update(ema, new_params, cfg.ema_decay)

            # Non-finite guard: one poisoned step must not destroy the
            # run. A bf16 production run once went loss 0.32 -> nan in
            # a single step with fully-finite input tables — an inf
            # gradient turns into NaN params via clip-by-global-norm
            # (scale = max_norm/inf = 0, and 0*inf = NaN). When the loss
            # or the global grad norm is non-finite, keep the old params /
            # optimizer states / EMA wholesale: the step is skipped, the
            # loss log prints the nan honestly, and training continues
            # from intact state. The host loop aborts if this persists
            # (see train()).
            ok = jnp.isfinite(loss) & jnp.isfinite(optax.global_norm(grads))

            def keep_if_ok(new, old):
                return jax.tree.map(
                    lambda n, o: jnp.where(ok, n, o), new, old
                )

            new_params = keep_if_ok(new_params, state.params)
            new_opt_states = keep_if_ok(new_opt_states, state.opt_states)
            if ema is not None:
                ema = keep_if_ok(ema, state.ema_params)

            return (
                state.replace(
                    params=new_params,
                    opt_states=new_opt_states,
                    ema_params=ema,
                    step=state.step + 1,
                ),
                loss,
            )

        return jax.jit(train_step, donate_argnums=(0,))

    def _build_eval_step(self):
        cfg = self.config

        def eval_step(state: TrainState, batch, use_ema: bool):
            batch = self._unpack_transfer(batch)
            params = state.ema_params if (use_ema and state.ema_params is not None) else state.params
            # Single forward pass; loss computed from the same predictions
            # (the reference recomputes sample_model inside its loss path —
            # diffusion.py:830-857 — and an earlier draft here did too).
            image_pred, range_pred = self._apply_model(params, batch)

            def head_loss(pred, target):
                d = pred - target
                a = jnp.abs(d) if cfg.loss_type == "l1" else d**2
                return a.reshape(a.shape[0], -1).mean(axis=1)

            # Per-sample losses so the caller can mask padding out of the
            # mean (all samples share one shape, so the mean of per-sample
            # means equals the reference's global mean).
            loss_vec = jnp.zeros(batch["geometry"].shape[0], jnp.float32)
            if image_pred is not None:
                loss_vec = loss_vec + head_loss(image_pred, batch["displacement"])
            if range_pred is not None:
                sign_pred, log_pred = range_pred
                loss_vec = loss_vec + head_loss(
                    sign_pred, batch["sign_displacement_range"]
                )
                loss_vec = loss_vec + head_loss(
                    log_pred, batch["log_displacement_range"]
                )
            return image_pred, range_pred, loss_vec

        return jax.jit(eval_step, static_argnums=(2,))

    # ------------------------------------------------------------- batches
    def _fetch_batch(self, global_offset: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        count = cfg.train_batch_size * cfg.num_gradient_accumulation_steps
        idx = self.sampler.indices_at(global_offset, count)
        accum = cfg.num_gradient_accumulation_steps
        local_bs = cfg.train_batch_size
        pc = jax.process_count()
        if pc > 1:
            # multi-controller feed: each host decodes only the rows its
            # devices own. The batch axis shards ('dcn','dp') with the
            # dcn (process) axis outermost, so process p holds the
            # contiguous block [p*B/pc, (p+1)*B/pc) of every micro-batch
            # (shard_batch assembles the global array from these local
            # shards via make_array_from_process_local_data).
            assert cfg.train_batch_size % pc == 0
            local_bs = cfg.train_batch_size // pc
            p = jax.process_index()
            idx = (
                np.asarray(idx)
                .reshape(accum, cfg.train_batch_size)[
                    :, p * local_bs : (p + 1) * local_bs
                ]
                .reshape(-1)
            )
        if self.device_tables is not None:
            # device-resident store: ship index vectors, assemble in HBM
            from ..data.device_store import index_arrays

            batch = index_arrays(self.dataset, idx)
        else:
            samples = [self.dataset[int(i)] for i in idx]
            batch = self._pack_transfer(collate(samples))
        batch = {
            k: v.reshape((accum, local_bs) + v.shape[1:])
            for k, v in batch.items()
        }
        return shard_batch(self.mesh, batch, leading_unsharded=1)

    # ------------------------------------------------------------ main loop
    def train(self, wandb_inject_function: Optional[Callable] = None):
        cfg = self.config
        effective = len(self.dataset) / max(
            cfg.train_batch_size * cfg.num_gradient_accumulation_steps, 1
        )
        print(f"Epoch Size: {effective} effective batches")
        if effective:
            print(
                "Number of Effective Epochs: "
                f"{cfg.num_train_steps / effective}"
            )

        # Prefetch overlap: the device step for batch i runs while the host
        # decodes batch i+1 (the reference's DataLoader ran with
        # num_workers=0, serializing PNG decode with the GPU step). The
        # python-side step counter avoids blocking on the device counter.
        per_step = cfg.train_batch_size * cfg.num_gradient_accumulation_steps
        step = int(self.state.step)
        pbar = None
        if cfg.progress_bar and self.is_main:
            # reference: tqdm over the step loop on the main process
            # (diffusion.py:1000-1007)
            pbar = progress(
                initial=step, total=cfg.num_train_steps, desc="training"
            )

        next_batch = self._fetch_batch(step * per_step)
        # Loss logging is one step delayed: a blocking scalar fetch would
        # wait for the step to finish before the next one is dispatched,
        # so the device value is staged with copy_to_host_async and
        # converted on the NEXT iteration — by then the transfer has
        # landed behind the next dispatch.
        # pending_loss = (step_index, device_scalar).
        pending_loss = None
        # The in-graph non-finite guard (train_step) skips poisoned
        # updates silently; if EVERY step is non-finite something is
        # structurally wrong (bad checkpoint, broken feed) and burning
        # the remaining steps as no-ops would look like a hang. Abort
        # loudly after a long streak so the supervisor surfaces it.
        nan_streak = 0

        def resolve_pending():
            nonlocal pending_loss, nan_streak
            if pending_loss is None:
                return None
            s, arr = pending_loss
            pending_loss = None
            v = float(arr)
            if v == v and abs(v) != float("inf"):
                nan_streak = 0
            else:
                nan_streak += 1
                logging.warning(
                    f"step: {s}, non-finite loss ({v}) — update skipped "
                    f"by the non-finite guard ({nan_streak} consecutive)"
                )
                if nan_streak >= 50:
                    raise RuntimeError(
                        "50 consecutive non-finite losses: every step is "
                        "being skipped by the non-finite guard — aborting "
                        "so the resilient loop / operator can intervene"
                    )
            logging.info(f"step: {s}, loss: {v:.4f}")
            if pbar is not None:
                pbar.set_description(f"loss: {v:.4f}")
            return v

        while step < cfg.num_train_steps:
            batch = next_batch
            self.state, loss = self._train_step(
                self.state, batch, self.device_tables
            )  # async dispatch
            loss.copy_to_host_async()
            if step + 1 < cfg.num_train_steps:
                next_batch = self._fetch_batch((step + 1) * per_step)
            loss_value = resolve_pending()
            pending_loss = (step, loss)
            if pbar is not None:
                pbar.update(1)

            new_step = step + 1
            total_sample_loss = None
            image_filenames = None
            ranges = None
            milestone = None
            at_milestone = (
                new_step % cfg.num_steps_per_milestone == 0
                or new_step % cfg.num_steps_per_soft_milestone == 0
            )
            if wandb_inject_function is not None or at_milestone:
                # wandb needs the exact value for this step; milestones
                # block on the device anyway, so keep the log ordered.
                loss_value = resolve_pending()
            if new_step % cfg.num_steps_per_milestone == 0:
                image_filenames, ranges, total_sample_loss = self.sample_and_save()
                logging.info(f"sample loss: {total_sample_loss:.4f}")
                if total_sample_loss < float(self.state.lowest_sample_loss):
                    self.state = self.state.replace(
                        lowest_sample_loss=jnp.asarray(
                            total_sample_loss, jnp.float32
                        )
                    )
                    milestone = "best"
                else:
                    milestone = "latest"
                self.save_checkpoint(milestone)
            elif new_step % cfg.num_steps_per_soft_milestone == 0:
                _, _, total_sample_loss = self.sample_and_save(save=False)
                logging.info(f"sample loss: {total_sample_loss:.4f}")

            if wandb_inject_function is not None:
                wandb_inject_function(
                    new_step, loss_value, total_sample_loss, image_filenames,
                    ranges, milestone,
                )
            step = new_step

        resolve_pending()  # flush the final step's log line
        if pbar is not None:
            pbar.close()
        self.save_checkpoint("final")
        print("Training done!")

    # ------------------------------------------------------------ sampling
    @staticmethod
    def _view_friendly(image: np.ndarray) -> np.ndarray:
        """[-1,1] -> 'Greys' colormap pixels: high value -> dark
        (reference create_view_friendly_image + plt Greys, diffusion.py:774,963)."""
        v01 = np.clip((image + 1.0) / 2.0, 0.0, 1.0)
        return np.round((1.0 - v01) * 255.0).astype(np.uint8)

    @staticmethod
    def _view_friendly_range(sign_out: np.ndarray, log_out: np.ndarray):
        sign = (sign_out < 0.5).astype(np.int32) * 2 - 1
        return sign * (np.exp(log_out) - 1.0)

    def sample_and_save(
        self,
        milestone=None,
        save: bool = True,
        progress_bar: bool = False,
        use_ema: bool = False,
    ):
        cfg = self.config
        # every process runs the SPMD eval step (the loss reduction is
        # global), but only the main host writes images/ranges
        # (reference diffusion.py:613 is_main_process gate)
        save = save and self.is_main
        n = len(self.sample_dataset)
        bs = self.sample_batch_size
        num_conditions = self.sample_dataset.conditions_per_plate_geometry
        num_steps = self.sample_dataset.num_steps

        image_filenames: List[str] = []
        all_ranges: List[np.ndarray] = []
        loss_sum = 0.0
        loss_count = 0

        starts = range(0, n, bs)
        if progress_bar:
            starts = progress(starts, desc="sampling", total=(n + bs - 1) // bs)
        for start in starts:
            idx = list(range(start, min(start + bs, n)))
            # static batch shape: pad by repeating the last sample
            pad = bs - len(idx)
            samples = [self.sample_dataset[i] for i in idx + [idx[-1]] * pad]
            pc = jax.process_count()
            if pc > 1:
                # each host feeds only its block of the sharded batch
                # axis (same layout contract as _fetch_batch)
                per = bs // pc
                lo = jax.process_index() * per
                samples = samples[lo : lo + per]
            batch = shard_batch(self.mesh, collate(samples))
            image_pred, range_pred, loss_vec = self._eval_step(
                self.state, batch, use_ema
            )
            if pc > 1:
                # outputs are batch-sharded across hosts; gather them to
                # every host so the loss bookkeeping (and the main
                # host's file writes) see the global batch
                from jax.experimental import multihost_utils

                image_pred, range_pred, loss_vec = jax.tree.map(
                    lambda x: multihost_utils.process_allgather(
                        x, tiled=True
                    ),
                    (image_pred, range_pred, loss_vec),
                )
            # mask the padded (repeated) tail out of the reported loss
            loss_sum += float(np.asarray(loss_vec)[: len(idx)].sum())
            loss_count += len(idx)
            if not save:
                continue

            image_pred = None if image_pred is None else np.asarray(image_pred)
            for j, sample_index in enumerate(idx):
                # defer to the dataset's own index decomposition so a
                # non-default sample_start_plate_index saves predictions
                # under the plate the inputs actually came from (a
                # hardcoded +1 here silently mislabels them and accuracy
                # then scores against the wrong ground truth)
                ids_of = getattr(self.sample_dataset, "index_to_ids", None)
                if ids_of is not None:
                    plate, condition, step = ids_of(sample_index)
                else:
                    plate = sample_index // (num_conditions * num_steps) + 1
                    condition = (
                        sample_index % (num_conditions * num_steps)
                    ) // num_steps + 1
                    step = (
                        sample_index % (num_conditions * num_steps)
                    ) % num_steps + 1
                if milestone is not None:
                    pathname = (
                        self.results_folder / f"{milestone}" / f"{plate}" / f"{condition}"
                    )
                else:
                    pathname = self.results_folder / f"{plate}" / f"{condition}"
                pathname.mkdir(parents=True, exist_ok=True)

                if image_pred is not None:
                    for channel, axis in ((0, "x"), (1, "y")):
                        img = self._view_friendly(image_pred[j, :, :, channel])
                        fname = str(pathname / f"sample_{axis}_{step}.png")
                        write_png(fname, img)
                        image_filenames.append(fname)
                if range_pred is not None:
                    sign_out = np.asarray(range_pred[0][j])
                    log_out = np.asarray(range_pred[1][j])
                    rng_val = self._view_friendly_range(sign_out, log_out)
                    all_ranges.append(rng_val)
                    for axis in ("x", "y"):
                        np.savetxt(
                            str(pathname / f"sample_{axis}_{step}.txt"), rng_val
                        )

        total_loss = loss_sum / max(loss_count, 1)
        return (
            image_filenames if (image_filenames and save) else None,
            all_ranges if all_ranges else None,
            total_loss,
        )

    # --------------------------------------------------------- checkpoints
    # The reference's legacy .pt path (old_save_checkpoint /
    # old_load_checkpoint, diffusion.py:599-610, 670-689) existed to read
    # torch pickles from its earlier runs; it has no JAX analog and is
    # intentionally not carried over — `model-<milestone>/checkpoint.npz`
    # (+ zip artifacts, train/checkpoint.py) is the only format here.
    def _ckpt_dir(self, milestone) -> Path:
        return self.results_folder / f"model-{milestone}"

    def save_checkpoint(self, milestone):
        # Every process fetches the (replicated) state and reaches the
        # barrier; only the main process touches the filesystem
        # (reference wait_for_everyone + is_main_process,
        # diffusion.py:567, 613).
        state = jax.device_get(self.state)
        sync_processes(f"save_checkpoint_{milestone}")
        if not self.is_main:
            return
        if milestone == "latest":
            # rotate latest -> latest-prev (reference diffusion.py:647-668)
            prev_dir = self._ckpt_dir("latest-prev")
            prev_zip = self.results_folder / "model-latest-prev.zip"
            for p in (prev_dir, prev_zip):
                if p.exists():
                    shutil.rmtree(p) if p.is_dir() else p.unlink()
            cur_dir = self._ckpt_dir("latest")
            cur_zip = self.results_folder / "model-latest.zip"
            if cur_dir.exists():
                cur_dir.rename(prev_dir)
            if cur_zip.exists():
                cur_zip.rename(prev_zip)
        else:
            self.delete_checkpoint_if_exists(milestone)

        path = self._ckpt_dir(milestone)
        checkpoint.save(path, state)
        # zip artifact alongside the directory (reference zips + deletes the
        # dir, diffusion.py:623-631; we keep the dir for fast resume and add
        # the zip for artifact upload parity)
        zip_path = self.results_folder / f"model-{milestone}.zip"
        with zipfile.ZipFile(zip_path, "w") as zf:
            for file in path.rglob("*"):
                if file.is_file():
                    zf.write(file, arcname=file.relative_to(self.results_folder))

    def delete_checkpoint_if_exists(self, milestone):
        path = self._ckpt_dir(milestone)
        if path.exists():
            shutil.rmtree(path)
        zip_path = self.results_folder / f"model-{milestone}.zip"
        if zip_path.exists():
            zip_path.unlink()

    def unzip_checkpoint(self, milestone):
        with zipfile.ZipFile(
            self.results_folder / f"model-{milestone}.zip", "r"
        ) as zf:
            zf.extractall(self.results_folder)

    def load_checkpoint(self, milestone):
        """`milestone='auto'` resumes from whichever saved checkpoint
        (best / latest / latest-prev / final) has the highest step — the
        newest checkpoint alternates between 'best' and 'latest'
        depending on sample loss, so a fixed name can silently lose a
        milestone of progress on crash-resume.

        A checkpoint's EMA weights need not match this config's: the
        raw-vs-EMA eval loop restores one checkpoint under both
        templates. Extra EMA weights are dropped; asking for EMA weights
        a checkpoint lacks raises."""
        if milestone == "auto":
            milestone = self._newest_milestone()
            if milestone is None:
                # Crash-resume before the first milestone ever saved:
                # nothing to restore — start fresh instead of dying, so
                # a supervisor can always pass `--checkpoint auto`.
                print("auto-resume: no checkpoint yet, starting fresh")
                return
            print(f"auto-resume: milestone '{milestone}'")
        path = self._ckpt_dir(milestone)
        if not path.exists() and (
            self.results_folder / f"model-{milestone}.zip"
        ).exists():
            self.unzip_checkpoint(milestone)
        flat = checkpoint.load_flat(path)
        has_ema = any(k.startswith("ema_params/") for k in flat)
        template = jax.device_get(self.state)
        if template.ema_params is not None and not has_ema:
            raise ValueError(
                f"checkpoint '{milestone}' carries no EMA weights "
                "(trained without --use_ema_model); sample without "
                "--use_ema"
            )
        if has_ema and template.ema_params is None:
            print(
                "note: checkpoint carries EMA weights; restoring "
                "raw params (pass --use_ema to sample through EMA)"
            )
        self.state = replicate(self.mesh, checkpoint.restore(template, flat))

    def _newest_milestone(self) -> Optional[str]:
        best = None
        for name in ("final", "best", "latest", "latest-prev"):
            path = self._ckpt_dir(name)
            if not (path / checkpoint.FILENAME).is_file():
                continue
            try:
                step = int(checkpoint.load_flat(path, ("step",))["step"])
            except (OSError, KeyError, ValueError, zipfile.BadZipFile):
                continue  # unreadable checkpoint: resume from another
            if best is None or step > best[1]:
                best = (name, step)
        return None if best is None else best[0]
