#!/bin/bash
# The flagship experiment: two equal-wall-clock Copenhagen 11x11 gated runs
# (decisive gate, arena every 4 iterations, resign 0.95 after 20 moves,
# 128-sim search), PUCT vs Gumbel + sample-early, then one anchored
# cross-ladder (net-free anchors, 128-sim noise-free arena). The port's form
# of the root scripts/experiments/flagship_r4_ab.sh: same arms, flags, seeds
# and stages, on the CUDA card. Run the arms one after the other, from the
# directory that should hold runs/:
#
#   HOURS=3.0 bash flagship_r4_ab.sh [puct|gumbel|ladder]
set -ex
HOURS="${HOURS:-3.0}"
COMMON="--preset copenhagen --iterations 100000 --games 512
 --selfplay-batch 512 --max-game-len 256 --temp-threshold 12
 --resign 0.95 --resign-min-moves 20 --sims 128 --children 32
 --alpha-scale 10 --train-steps 160 --batch 512 --replay-capacity 600000
 --lr 0.002 --channels 64 --blocks 6 --norm group
 --arena-games 64 --arena-sims 64 --arena-max-len 200 --arena-every 4
 --gate 0.55 --gate-on decisive --gate-min-decisive 4
 --checkpoint-every 8 --checkpoint-keep 24 --seed 42"
stage="${1:-all}"
if [ "$stage" = puct ] || [ "$stage" = all ]; then
  python -m alphazeroforhnefatafl_tpu_torch.scripts.train_run --name copenhagen_r4ab_puct --hours "$HOURS" $COMMON
fi
if [ "$stage" = gumbel ] || [ "$stage" = all ]; then
  python -m alphazeroforhnefatafl_tpu_torch.scripts.train_run --name copenhagen_r4ab_gumbel --hours "$HOURS" \
    $COMMON --gumbel --gumbel-sample-early
fi
if [ "$stage" = ladder ] || [ "$stage" = all ]; then
  python -m alphazeroforhnefatafl_tpu_torch.scripts.cross_ladder --preset copenhagen \
    --entry puct=runs/copenhagen_r4ab_puct/ckpt:latest \
    --entry puct_mid=runs/copenhagen_r4ab_puct/ckpt:mid \
    --entry gumbel=runs/copenhagen_r4ab_gumbel/ckpt:latest \
    --entry gumbel_mid=runs/copenhagen_r4ab_gumbel/ckpt:mid \
    --anchors uniform,material,random --games 24 --sims 128 --children 32 \
    --channels 64 --blocks 6 --max-game-len 200 \
    --out runs/copenhagen_r4ab_ladder.json
fi
echo FLAGSHIP_R4_AB_DONE
