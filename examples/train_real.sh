#!/usr/bin/env bash
# Production pipeline: generate the full production dataset in-framework, build the decoded-on-disk condition
# store, train the flagship FDN-UNet 10k steps with EMA, then score
# surrogate MAE with the accuracy CLI both raw and through EMA.
# Reference bar: MAE 0.0144 on 100k samples (reference README.md:10);
# reference production datagen config: 2500 plates x 4 conditions x
# 6 steps at 512px (generate_data_GT.sh:1-10).
#
# Defaults: 4000 plates (~80k samples). Override via env:
# PLATES=400 STEPS=2000 bash examples/train_real.sh
# Every stage is idempotent (.done markers, resumable store build,
# --checkpoint auto training resume), so a failed run is resumed by
# running the script again.
set -euo pipefail

PLATES=${PLATES:-4000}
EVAL_PLATES=${EVAL_PLATES:-16}
STEPS=${STEPS:-10000}
BS=${BS:-16}
ROOT=${ROOT:-runs3}
DTYPE=${DTYPE:-bfloat16}
DATA=$ROOT/train_data
STORE=$ROOT/store256
EVAL=$ROOT/eval_data
RES=$ROOT/results

mkdir -p "$ROOT"

if [ ! -f "$DATA/.done" ]; then
  python -m fea_tpu generate --batched --batch_size 8 \
    --num_plates "$PLATES" --conditions_per_plate 4 --steps_per_condition 6 \
    --mesh_size 1e-2 --image_size 512 --save_displacement \
    --data_dir "$DATA" --seed 300
  touch "$DATA/.done"
fi

if [ ! -f "$EVAL/.done" ]; then
  # --save_meshes writes the per-step domain.N.vtk ground truth that the
  # accuracy CLI samples predictions against.
  python -m fea_tpu generate --batched --batch_size 8 \
    --num_plates "$EVAL_PLATES" --conditions_per_plate 4 --steps_per_condition 6 \
    --mesh_size 1e-2 --image_size 512 --save_displacement --save_meshes \
    --data_dir "$EVAL" --seed 900
  touch "$EVAL/.done"
fi

# Decoded-on-disk condition store: ~460 KB/condition, feeds training at
# device speed at any dataset scale (the RAM cache tops out ~20k samples).
python -m fea_tpu store --data_dir "$DATA" --store_dir "$STORE" \
  --num_plates "$PLATES" --image_size 256 \
  --conditions_per_plate 4 --steps_per_condition 6

DATA="$DATA" EVAL="$EVAL" RES="$RES" STEPS="$STEPS" BS="$BS" \
  STORE="$STORE" DTYPE="$DTYPE" EMA=1 \
  bash "$(dirname "$0")/train_loop_resume.sh"

# Score the best checkpoint raw and through the EMA weights; keep the
# winner (the reference notebooks sample through ema_pytorch.EMA,
# generateapplication.ipynb cell 16).
# SKIP_RAW_EVAL=1 evaluates only through EMA.
EVAL_FLAGS=("" "--use_ema")
if [ "${SKIP_RAW_EVAL:-0}" = 1 ]; then EVAL_FLAGS=("--use_ema"); fi
for ema_flag in "${EVAL_FLAGS[@]}"; do
  timeout 3600 python -m fea_tpu sample --milestone best \
    --data_dir "$DATA" --sample_data_dir "$EVAL" \
    --image_size 256 --batch_size "$BS" \
    --num_steps_per_condition 6 --num_sample_conditions_per_plate 4 \
    --results_dir "$RES" $ema_flag

  echo "=== accuracy ${ema_flag:-raw} ==="
  timeout 1800 python -m fea_tpu accuracy \
    --data_dir "$EVAL" --results_dir "$RES" --milestone best \
    --image_size 256 --num_plates "$EVAL_PLATES" --conditions_per_plate 4 \
    --steps_per_condition 6
done

# Application workflow with the trained surrogate (the reference's
# "serve" analog, generateapplication.ipynb): per-app GT solve +
# surrogate prediction + accuracy, so the serve artifact is regenerated
# whenever the model is.
if [ "${SKIP_APPS:-0}" = 1 ]; then exit 0; fi
for app in cantilever gusset shearblade; do
  echo "=== app $app ==="
  timeout 3600 python -m fea_tpu app "$app" \
    --output_dir "$ROOT/app_eval/$app" \
    --checkpoint "$RES/model-best" --use_ema || echo "app $app failed"
done
