#!/bin/sh
# Production ground-truth datagen config — the reference's
# generate_data_GT.sh (2500 plates x 4 conditions x 6 steps, 512px,
# save_meshes), on the accelerator pipeline.
python -m fea_tpu generate \
    --num_plates 2500 \
    --conditions_per_plate 4 \
    --steps_per_condition 6 \
    --image_size 512 \
    --save_displacement \
    --save_meshes \
    --data_dir data \
    --seed 0
