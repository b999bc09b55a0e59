#!/usr/bin/env bash
# Crash-resilient training driver: milestones save every 500 steps and
# `--checkpoint auto` resumes from the newest readable checkpoint, so
# looping the CLI until it exits 0 completes the run losing at most one
# milestone per crash (a single iteration when nothing fails).
#
# Usage: DATA=runs/train_data EVAL=runs/eval_data RES=runs/results \
#        STEPS=10000 [STORE=runs/store256] [DTYPE=bfloat16] [EMA=1] \
#        bash examples/train_loop_resume.sh
set -u

DATA=${DATA:-runs/train_data}
EVAL=${EVAL:-runs/eval_data}
RES=${RES:-runs/results}
STEPS=${STEPS:-10000}
BS=${BS:-16}

extra=()
# decoded-on-disk condition store (build with `fea_tpu store`): feeds
# production-scale datasets at device speed
if [ -n "${STORE:-}" ]; then
  extra+=(--dataset_store "$STORE")
  # pre-warm the page cache: random-access memmap reads are ~25x slower
  # cold (37 ms vs 1.4 ms/sample measured); one sequential read fixes it
  cat "$STORE"/*.npy "$STORE"/*.npz > /dev/null 2>&1 || true
fi
# bf16 compute with f32 master weights
[ -n "${DTYPE:-}" ] && extra+=(--compute_dtype "$DTYPE")
# track EMA weights (the reference notebooks sample through EMA)
[ -n "${EMA:-}" ] && extra+=(--use_ema_model)

if [ -d "$RES/model-latest" ] || [ -d "$RES/model-best" ]; then
  extra+=(--checkpoint auto)
  resumed=1
else
  resumed=0
fi

# Device-resident condition tables: batches assembled on device from
# index vectors (~100 bytes/step of host traffic). Staged fallback: two
# consecutive fast failures (< FAST_FAIL_S, e.g. an out-of-memory at
# init) first halve the micro-batch, then drop the resident tables
# entirely — the host feed is the known-good path. Default ON whenever
# a store is in play (bit-exact vs the host feed); DEVRES=0 opts out.
case "${DEVRES-auto}" in
  auto)
    devres_mode=""
    if [ -n "${STORE:-}" ]; then
      devres_mode=tables
      # A production-sized store starts at tables+accum (smaller step
      # temporaries beside the resident tables).
      store_kb=$(du -sk "$STORE" 2>/dev/null | cut -f1 || echo 0)
      if [ "${store_kb:-0}" -gt $((5 * 1024 * 1024)) ]; then
        devres_mode="tables+accum"
        echo "store is $((store_kb / 1024 / 1024)) GB: starting at feed mode tables+accum"
      fi
    fi
    ;;
  0 | "") devres_mode="" ;;
  tables+accum) devres_mode="tables+accum" ;;
  *) devres_mode=tables ;;
esac
# devres_mode: tables -> tables+accum -> off.
# tables+accum halves the train step's HLO temps (micro-batch BS/2 x 2
# accumulation steps, same effective batch), which is the fitting rung
# when the resident tables leave too little device memory for the
# single-pass step.
FAST_FAIL_S=${FAST_FAIL_S:-900}
fast_fails=0

for attempt in $(seq 1 40); do
  run_extra=()
  case "${devres_mode:-off}" in
    tables) run_extra=(--device_resident_store) ;;
    tables+accum) run_extra=(--device_resident_store \
      --batch_size $((BS / 2)) --num_gradient_accumulation_steps 2) ;;
  esac
  t_start=$(date +%s)
  python -m fea_tpu train \
    --data_dir "$DATA" --sample_data_dir "$EVAL" \
    --image_size 256 --batch_size "$BS" --num_steps "$STEPS" \
    --learning_rate 3e-4 --num_steps_per_milestone 500 \
    --conditions_per_plate 4 --num_steps_per_condition 6 \
    --num_steps_per_sample_condition 6 --num_sample_conditions_per_plate 1 \
    --skip_dataset_size_check \
    --results_dir "$RES" "${extra[@]}" ${run_extra[@]+"${run_extra[@]}"}
  rc=$?
  echo "ATTEMPT $attempt EXIT $rc (mode ${devres_mode:-off})"
  [ $rc -eq 0 ] && exit 0
  if [ "$resumed" = 0 ]; then extra+=(--checkpoint auto); resumed=1; fi
  if [ $(($(date +%s) - t_start)) -lt "$FAST_FAIL_S" ]; then
    fast_fails=$((fast_fails + 1))
  else
    fast_fails=0
  fi
  if [ "$fast_fails" -ge 2 ] && [ -n "${devres_mode:-}" ]; then
    case "$devres_mode" in
      tables) devres_mode="tables+accum" ;;
      *) devres_mode="" ;;
    esac
    fast_fails=0
    echo "fallback: feed mode now '${devres_mode:-off}'"
  fi
  sleep 20
done
exit 1
