#!/bin/bash
# GroupNorm vs norm-free (--norm none) trunk at equal iterations (200 x 32
# games, Brandubh 7x7, 32 sims), then each arm's checkpoints laddered
# against the net-free anchors. The port's form of the root
# scripts/experiments/norm_ab.sh: same arms, flags and seeds. Run from the
# directory that should hold runs/.
set -x
for NORM in group none; do
  python -m alphazeroforhnefatafl_tpu_torch.scripts.train_run --cpu --name brandubh_ab_norm_$NORM --preset brandubh \
    --iterations 200 --games 32 --selfplay-batch 32 --max-game-len 60 \
    --temp-threshold 6 --sims 32 --children 16 \
    --train-steps 40 --batch 128 --min-replay 512 --replay-capacity 20000 \
    --lr 0.002 --channels 16 --blocks 2 --norm $NORM \
    --arena-every 0 --checkpoint-every 50 --checkpoint-keep 5 --seed 21
done
for NORM in group none; do
  python -m alphazeroforhnefatafl_tpu_torch.scripts.eval_run --cpu --ckpt runs/brandubh_ab_norm_$NORM/ckpt \
    --preset brandubh --games 32 --sims 32 --children 16 \
    --channels 16 --blocks 2 --norm $NORM --max-steps 2 --max-game-len 60 \
    --anchors uniform,material,random > runs/brandubh_ab_norm_$NORM/ladder_anchored.json
done
echo NORM_AB_DONE
