"""Training loop for the conditional-diffusion mode (BASELINE config 4).

A lean counterpart of the regression Trainer for GaussianDiffusion: the
FDN-UNet denoiser is conditioned on [forces, constraints, materials]
(5 channels) and learns the displacement image distribution; EMA params
track the online params and drive sampling. Shares the DP mesh, dataset,
and checkpoint format (train/checkpoint.py) of train.trainer.
"""

import dataclasses
import logging
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..data.dataset import EpochSampler, FEADataset, collate
from ..models.diffusion import GaussianDiffusion, make_diffusion_model
from ..parallel.mesh import make_mesh, replicate, shard_batch
from . import checkpoint
from .ema import ema_update


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DiffusionState:
    params: Any
    opt_state: Any
    ema_params: Any
    rng: jnp.ndarray
    step: jnp.ndarray

    replace = dataclasses.replace


@dataclass
class DiffusionConfig:
    dataset_folder: str = "data"
    dataset_image_size: int = 256
    conditions_per_plate: int = 4
    num_steps_per_condition: int = 6
    train_batch_size: int = 16
    train_learning_rate: float = 1e-4
    num_train_steps: int = 10000
    num_steps_per_milestone: int = 500
    timesteps: int = 1000
    objective: str = "pred_noise"
    ema_decay: float = 0.995
    input_dim: int = 64
    num_stages: int = 4
    results_folder: str = "results_diffusion"
    seed: int = 0
    n_devices: Optional[int] = None
    skip_dataset_size_check: bool = False


class DiffusionTrainer:
    def __init__(self, config: DiffusionConfig, dataset=None):
        self.config = config
        self.mesh = make_mesh(config.n_devices)
        assert config.train_batch_size % self.mesh.devices.size == 0

        self.dataset = dataset if dataset is not None else FEADataset(
            config.dataset_folder,
            image_size=config.dataset_image_size,
            conditions_per_plate=config.conditions_per_plate,
            num_steps=config.num_steps_per_condition,
        )
        if not config.skip_dataset_size_check:
            assert len(self.dataset) >= 100
        self.sampler = EpochSampler(len(self.dataset), seed=config.seed)

        self.diffusion: GaussianDiffusion = make_diffusion_model(
            image_size=config.dataset_image_size,
            input_dim=config.input_dim,
            num_stages=config.num_stages,
            timesteps=config.timesteps,
            objective=config.objective,
        )
        self.optimizer = optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adam(config.train_learning_rate, b1=0.9, b2=0.99),
        )

        rng = jax.random.PRNGKey(config.seed)
        variables = self.diffusion.init(rng, config.dataset_image_size)
        params = variables["params"]
        self.state = replicate(
            self.mesh,
            DiffusionState(
                params=params,
                opt_state=self.optimizer.init(params),
                ema_params=jax.tree.map(jnp.copy, params),
                rng=rng,
                step=jnp.zeros((), jnp.int32),
            ),
        )
        self.results_folder = Path(config.results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self._train_step = self._build_train_step()

    @staticmethod
    def batch_condition(batch: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate(
            [batch["forces"], batch["constraints"], batch["materials"]],
            axis=-1,
        )

    def _build_train_step(self):
        diffusion = self.diffusion
        optimizer = self.optimizer
        decay = self.config.ema_decay

        def step_fn(state: DiffusionState, x0, condition):
            rng, rng_loss = jax.random.split(state.rng)
            loss, grads = jax.value_and_grad(diffusion.loss)(
                state.params, rng_loss, x0, condition
            )
            updates, opt_state = optimizer.update(
                grads, state.opt_state, state.params
            )
            params = optax.apply_updates(state.params, updates)
            ema = ema_update(state.ema_params, params, decay)
            return (
                state.replace(
                    params=params,
                    opt_state=opt_state,
                    ema_params=ema,
                    rng=rng,
                    step=state.step + 1,
                ),
                loss,
            )

        return jax.jit(step_fn, donate_argnums=(0,))

    def _fetch(self, offset: int):
        idx = self.sampler.indices_at(offset, self.config.train_batch_size)
        batch = collate([self.dataset[int(i)] for i in idx])
        x0 = shard_batch(self.mesh, batch["displacement"])
        cond = shard_batch(self.mesh, self.batch_condition(batch))
        return x0, cond

    def train(self, log_every: int = 10):
        cfg = self.config
        step = int(self.state.step)
        while step < cfg.num_train_steps:
            x0, cond = self._fetch(step * cfg.train_batch_size)
            self.state, loss = self._train_step(self.state, x0, cond)
            if (step + 1) % log_every == 0:
                logging.info(f"diffusion step {step}: loss {float(loss):.4f}")
            if (step + 1) % cfg.num_steps_per_milestone == 0:
                self.save_checkpoint(step + 1)
            step += 1
        self.save_checkpoint("final")
        return float(loss)

    def sample(self, condition: np.ndarray, num_steps: Optional[int] = None,
               use_ema: bool = True, seed: int = 0):
        params = self.state.ema_params if use_ema else self.state.params
        return self.diffusion.sample(
            params, jax.random.PRNGKey(seed), jnp.asarray(condition), num_steps
        )

    def save_checkpoint(self, milestone):
        path = self.results_folder / f"model-{milestone}"
        if path.exists():
            shutil.rmtree(path)
        checkpoint.save(path, self.state)

    def load_checkpoint(self, milestone):
        path = self.results_folder / f"model-{milestone}"
        restored = checkpoint.restore(
            jax.device_get(self.state), checkpoint.load_flat(path)
        )
        self.state = replicate(self.mesh, restored)
