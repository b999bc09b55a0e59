"""Command-line entry points: `python -m fea_tpu <command>`.

Mirrors the reference's four scripts + application workflow
(generate_data.py, train_model.py, sample_model.py, calculate_accuracy.py,
test_nbs/generateapplication.ipynb) as subcommands of one CLI.
"""

import argparse
import os


def _add_generate(sub):
    p = sub.add_parser("generate", help="Generate the FEA dataset.")
    p.add_argument("--num_plates", type=int, default=1)
    p.add_argument("--start_plate", type=int, default=None)
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--steps_per_condition", type=int, default=11)
    p.add_argument("--mesh_size", type=float, default=1e-2)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--save_meshes", action="store_true")
    p.add_argument("--save_displacement", action="store_true")
    p.add_argument("--save_strain", action="store_true")
    p.add_argument("--save_stress", action="store_true")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batched", action="store_true",
                   help="vmapped multi-plate device solve path")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=None,
                   help="Shard the batched plate axis over this many "
                        "devices (a ('dp',) jax.sharding.Mesh)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default=None)
    return p


def _cmd_generate(args):
    assert (
        args.save_displacement or args.save_strain or args.save_stress
    ), "Must save at least one of displacement, strain, or stress."

    wandb_fn = None
    if args.use_wandb:
        import wandb

        assert args.wandb_project is not None, "Must specify wandb project name."
        wandb.init(project=args.wandb_project)

        def wandb_fn(plate_index, total_time, remaining):
            wandb.log(
                {
                    "plate_index": plate_index,
                    "total_time": total_time,
                    "remaining": remaining,
                }
            )

    if args.batched:
        import json as _json

        from .datagen.batched import generate_data_batched

        stats = generate_data_batched(
            data_dir=args.data_dir,
            image_size=args.image_size,
            num_plates=args.num_plates,
            start_plate=args.start_plate,
            conditions_per_plate=args.conditions_per_plate,
            mesh_size=args.mesh_size,
            save_displacement=args.save_displacement,
            save_strain=args.save_strain,
            save_stress=args.save_stress,
            num_steps_per_condition=args.steps_per_condition,
            save_meshes=args.save_meshes,
            seed=args.seed,
            batch_size=args.batch_size,
            n_devices=args.num_devices,
            wandb_inject_function=wandb_fn,
        )
        # one-line solver telemetry so production logs record the
        # failure/rejection rates
        print(
            "solver stats: "
            + _json.dumps({
                k: stats.get(k)
                for k in (
                    "plates", "solves", "cg_failures", "direct_fallbacks",
                    "cg_resamples", "continuations", "host_rejections",
                    "lane_dispatches",
                )
            })
        )
        return stats

    from .datagen import generate_data

    return generate_data(
        data_dir=args.data_dir,
        image_size=args.image_size,
        num_plates=args.num_plates,
        start_plate=args.start_plate,
        conditions_per_plate=args.conditions_per_plate,
        mesh_size=args.mesh_size,
        save_displacement=args.save_displacement,
        save_strain=args.save_strain,
        save_stress=args.save_stress,
        num_steps_per_condition=args.steps_per_condition,
        save_meshes=args.save_meshes,
        seed=args.seed,
        wandb_inject_function=wandb_fn,
    )


def _add_train(sub):
    p = sub.add_parser("train", help="Train the FDN-UNet surrogate.")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--sample_data_dir", type=str, default="sample_data")
    p.add_argument("--num_steps_per_condition", type=int, default=6)
    p.add_argument("--num_steps_per_sample_condition", type=int, default=6)
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--num_sample_conditions_per_plate", type=int, default=1)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--skip_dataset_size_check", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--cache_dataset", action="store_true", default=None,
                   help="Keep decoded samples in RAM (~2 MB each at "
                        "256px). Default: auto (on when the dataset has "
                        "<= 20k samples).")
    p.add_argument("--dataset_store", type=str, default=None,
                   help="decoded-on-disk condition store built with "
                        "`fea_tpu store`; feeds production-scale datasets "
                        "at device speed (overrides --data_dir for the "
                        "train set)")
    p.add_argument("--device_resident_store", action="store_true",
                   help="with --dataset_store: upload the condition "
                        "tables to HBM once and assemble batches on "
                        "device from index vectors (~100 bytes/step of "
                        "host traffic); bit-exact, auto-falls back when "
                        "tables exceed the HBM cap "
                        "(FEA_TPU_DEVICE_STORE_CAP)")
    p.add_argument("--no_cache_dataset", dest="cache_dataset",
                   action="store_false", help=argparse.SUPPRESS)
    p.add_argument("--num_gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_steps", type=int, default=10000)
    p.add_argument("--num_steps_per_milestone", type=int, default=500)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--loss_type", type=str, default="l1", choices=["l1", "l2"])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--disable_auxiliary", action="store_true", default=None)
    p.add_argument("--only_auxiliary", action="store_true")
    p.add_argument("--use_ema_model", action="store_true")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="bfloat16 = mixed precision: bf16 compute, "
                        "f32 master weights (no loss scaling needed)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the forward pass during backward "
                        "(~1/3 more FLOPs, near-zero stored activations) "
                        "— use when --device_resident_store tables + "
                        "activations crowd HBM")
    p.add_argument("--no_progress_bar", action="store_true")
    p.add_argument("--input_dim", type=int, default=64,
                   help="base channel width of the FDN-UNet (the "
                        "reference hardcodes 64, train_model.py:44); "
                        "smaller widths give cheap smoke runs")
    p.add_argument("--num_stages", type=int, default=4,
                   help="UNet depth (dim_mults length)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default=None)
    p.add_argument("--wandb_restrict_cache", type=int, default=10,
                   help="GB cap passed to `wandb artifact cache cleanup` "
                        "before each checkpoint upload")
    return p


def _cmd_train(args):
    from .train.trainer import Trainer, TrainerConfig

    config = TrainerConfig(
        dataset_folder=args.data_dir,
        sample_dataset_folder=args.sample_data_dir,
        dataset_image_size=args.image_size,
        train_batch_size=args.batch_size,
        num_gradient_accumulation_steps=args.num_gradient_accumulation_steps,
        num_train_steps=args.num_steps,
        num_steps_per_milestone=args.num_steps_per_milestone,
        train_learning_rate=args.learning_rate,
        loss_type=args.loss_type,
        num_steps_per_condition=args.num_steps_per_condition,
        num_steps_per_sample_condition=args.num_steps_per_sample_condition,
        conditions_per_plate=args.conditions_per_plate,
        num_sample_conditions_per_plate=args.num_sample_conditions_per_plate,
        results_folder=args.results_dir,
        skip_dataset_size_check=args.skip_dataset_size_check,
        cache_datasets=args.cache_dataset,
        dataset_store=args.dataset_store,
        device_resident_store=args.device_resident_store,
        remat_loss=args.remat,
        disable_auxiliary=(
            True if args.disable_auxiliary is None else args.disable_auxiliary
        ),
        only_auxiliary=args.only_auxiliary,
        use_ema=args.use_ema_model,
        compute_dtype=(
            None if args.compute_dtype in (None, "float32")
            else args.compute_dtype
        ),
        progress_bar=not args.no_progress_bar,
        input_dim=args.input_dim,
        num_stages=args.num_stages,
    )
    trainer = Trainer(config)
    if args.checkpoint is not None:
        trainer.load_checkpoint(args.checkpoint)

    wandb_fn = None
    if args.use_wandb and trainer.is_main:
        # multi-host: only the main process logs (reference
        # train_model.py wandb init under Accelerate's main process)
        import wandb

        assert args.wandb_project is not None, "Must specify wandb project name."
        wandb.init(project=args.wandb_project)
        wandb.define_metric("step")
        wandb.define_metric("train_loss", step_metric="step")
        wandb.define_metric("sample_loss", step_metric="step")

        def wandb_fn(step, loss, sample_loss, image_filenames, ranges, milestone):
            log = {"step": step, "train_loss": loss}
            if sample_loss is not None:
                log["sample_loss"] = sample_loss
            if image_filenames:
                log["samples"] = [wandb.Image(f) for f in image_filenames]
            if ranges is not None:
                log["ranges"] = ranges
            wandb.log(log)
            # checkpoint-zip artifact upload + cache cleanup (reference
            # train_model.py:108-114; the Trainer already writes the zips)
            if milestone is not None:
                if args.wandb_restrict_cache is not None:
                    os.system(
                        "wandb artifact cache cleanup "
                        f"{args.wandb_restrict_cache}GB"
                    )
                artifact = wandb.Artifact(
                    name=f"checkpoint-{wandb.run.id}", type="model"
                )
                if milestone == "latest":
                    prev = os.path.join(
                        args.results_dir, "model-latest-prev.zip"
                    )
                    if os.path.exists(prev):
                        artifact.add_file(prev)
                artifact.add_file(
                    os.path.join(args.results_dir, f"model-{milestone}.zip")
                )
                wandb.log_artifact(artifact)

    trainer.train(wandb_inject_function=wandb_fn)
    return trainer


def _add_store(sub):
    p = sub.add_parser(
        "store",
        help="Build the decoded-on-disk condition store for a generated "
             "dataset (resumable; can trail a running datagen via "
             "--follow_pid).",
    )
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--store_dir", type=str, required=True)
    p.add_argument("--num_plates", type=int, required=True)
    p.add_argument("--image_size", type=int, default=256,
                   help="training-time image size (the store holds "
                        "pre-resized grids)")
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--steps_per_condition", type=int, default=6)
    p.add_argument("--follow_pid", type=int, default=None)


def _cmd_store(args):
    from .data.store import build_condition_store

    build_condition_store(
        args.data_dir,
        args.store_dir,
        num_plates=args.num_plates,
        image_size=args.image_size,
        conditions_per_plate=args.conditions_per_plate,
        num_steps=args.steps_per_condition,
        follow_pid=args.follow_pid,
        verbose=True,
    )


def _add_train_diffusion(sub):
    p = sub.add_parser(
        "train-diffusion",
        help="Train the conditional-diffusion (DDPM) FDN-UNet mode.",
    )
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_steps", type=int, default=10000)
    p.add_argument("--num_steps_per_milestone", type=int, default=500)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--objective", type=str, default="pred_noise",
                   choices=["pred_noise", "pred_x0"])
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--num_steps_per_condition", type=int, default=6)
    p.add_argument("--results_dir", type=str, default="results_diffusion")
    p.add_argument("--skip_dataset_size_check", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def _cmd_train_diffusion(args):
    from .train.diffusion_trainer import DiffusionConfig, DiffusionTrainer

    config = DiffusionConfig(
        dataset_folder=args.data_dir,
        dataset_image_size=args.image_size,
        conditions_per_plate=args.conditions_per_plate,
        num_steps_per_condition=args.num_steps_per_condition,
        train_batch_size=args.batch_size,
        train_learning_rate=args.learning_rate,
        num_train_steps=args.num_steps,
        num_steps_per_milestone=args.num_steps_per_milestone,
        timesteps=args.timesteps,
        objective=args.objective,
        results_folder=args.results_dir,
        skip_dataset_size_check=args.skip_dataset_size_check,
    )
    DiffusionTrainer(config).train()


def _add_sample(sub):
    p = sub.add_parser("sample", help="Sample a trained model over a dataset.")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--sample_data_dir", type=str, default="sample_data")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--milestone", type=str, required=True)
    p.add_argument("--num_steps_per_condition", type=int, default=6)
    p.add_argument("--num_sample_conditions_per_plate", type=int, default=1)
    p.add_argument("--use_ema", action="store_true",
                   help="Sample with the EMA weights from the checkpoint "
                        "(reference generateapplication.ipynb cell 16 loads "
                        "checkpoints into an ema_pytorch.EMA wrapper)")
    p.add_argument("--input_dim", type=int, default=64,
                   help="must match the width the checkpoint was trained "
                        "with (see `train --input_dim`)")
    p.add_argument("--num_stages", type=int, default=4)
    return p


def _cmd_sample(args):
    from .train.trainer import Trainer, TrainerConfig

    config = TrainerConfig(
        dataset_folder=args.data_dir,
        sample_dataset_folder=args.sample_data_dir,
        dataset_image_size=args.image_size,
        train_batch_size=args.batch_size,
        num_steps_per_condition=args.num_steps_per_condition,
        num_steps_per_sample_condition=args.num_steps_per_condition,
        num_sample_conditions_per_plate=args.num_sample_conditions_per_plate,
        results_folder=args.results_dir,
        skip_dataset_size_check=True,
        inference_only=True,
        use_ema=args.use_ema,
        input_dim=args.input_dim,
        num_stages=args.num_stages,
    )
    trainer = Trainer(config)
    trainer.load_checkpoint(args.milestone)
    trainer.sample_and_save(
        milestone=args.milestone, progress_bar=True, use_ema=args.use_ema
    )


def _add_accuracy(sub):
    p = sub.add_parser("accuracy", help="Displacement accuracy vs ground truth.")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--milestone", type=str, default=None)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_plates", type=int, default=1)
    p.add_argument("--conditions_per_plate", type=int, default=4)
    p.add_argument("--steps_per_condition", type=int, default=6)
    p.add_argument("--per_step", action="store_true")
    p.add_argument("--progress", action="store_true",
                   help="progress over samples (300+ slow VTK/PNG reads at "
                        "production eval sizes)")
    return p


def _cmd_accuracy(args):
    from .metrics.accuracy import calculate_accuracy, calculate_accuracy_per_step

    fn = calculate_accuracy_per_step if args.per_step else calculate_accuracy
    out = fn(
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        milestone=args.milestone,
        image_size=args.image_size,
        num_plates=args.num_plates,
        conditions_per_plate=args.conditions_per_plate,
        steps_per_condition=args.steps_per_condition,
        progress=args.progress,
    )
    print(out)


def _add_app(sub):
    p = sub.add_parser("app", help="Run an application problem end to end.")
    p.add_argument(
        "name",
        choices=[
            "cantilever", "gusset", "shearblade", "composite",
            "composite_coupled",
        ],
    )
    p.add_argument("--output_dir", type=str, default="app_output")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Trained checkpoint for surrogate prediction + metrics")
    p.add_argument("--use_ema", action="store_true",
                   help="Predict with the checkpoint's EMA weights")
    return p


def _cmd_app(args):
    from .apps.runner import run_application

    out = run_application(
        args.name,
        output_dir=args.output_dir,
        image_size=args.image_size,
        checkpoint=args.checkpoint,
        use_ema=args.use_ema,
    )
    print(out)
    return out


def main(argv=None):
    """Run one command; returns what the command returns (datagen stats,
    the Trainer, the app report) for in-process callers."""
    # Join the multi-controller cluster (no-op single-process) BEFORE
    # anything touches the backend — see parallel/distributed.py.
    from .parallel.distributed import ensure_initialized

    ensure_initialized()
    from .utils.device import enable_compilation_cache

    enable_compilation_cache()
    parser = argparse.ArgumentParser(
        prog="fea_tpu", description="FEA + surrogate framework on JAX."
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_generate(sub)
    _add_train(sub)
    _add_store(sub)
    _add_train_diffusion(sub)
    _add_sample(sub)
    _add_accuracy(sub)
    _add_app(sub)
    args = parser.parse_args(argv)
    return {
        "generate": _cmd_generate,
        "train": _cmd_train,
        "store": _cmd_store,
        "train-diffusion": _cmd_train_diffusion,
        "sample": _cmd_sample,
        "accuracy": _cmd_accuracy,
        "app": _cmd_app,
    }[args.command](args)


if __name__ == "__main__":
    main()
