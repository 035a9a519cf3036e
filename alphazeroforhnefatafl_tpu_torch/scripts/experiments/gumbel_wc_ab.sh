#!/bin/bash
# PUCT vs Gumbel (+ --gumbel-sample-early) at equal wall clock (0.6 h arms)
# with decisive gating and resignation (min-moves floor) live, then one
# cross-ladder with the anchors and norm_ab.sh's GroupNorm arm. The port's
# form of the root scripts/experiments/gumbel_wc_ab.sh: same arms, flags and
# seeds. Run it after norm_ab.sh, from the same directory.
set -x
COMMON="--cpu --preset brandubh --hours 0.6 --iterations 100000 --games 32
 --selfplay-batch 32 --max-game-len 60 --temp-threshold 6
 --resign 0.9 --resign-min-moves 10 --sims 32 --children 16
 --train-steps 40 --batch 128 --min-replay 512 --replay-capacity 50000
 --lr 0.002 --channels 16 --blocks 2
 --arena-games 24 --arena-sims 16 --arena-max-len 60 --arena-every 1
 --gate 0.55 --gate-on decisive --gate-min-decisive 4
 --checkpoint-every 4 --checkpoint-keep 6 --seed 9"
python -m alphazeroforhnefatafl_tpu_torch.scripts.train_run --name brandubh_wc_puct $COMMON
python -m alphazeroforhnefatafl_tpu_torch.scripts.train_run --name brandubh_wc_gumbel $COMMON --gumbel --gumbel-sample-early
python -m alphazeroforhnefatafl_tpu_torch.scripts.cross_ladder --cpu --preset brandubh \
  --entry wc_puct=runs/brandubh_wc_puct/ckpt:latest \
  --entry wc_gumbel=runs/brandubh_wc_gumbel/ckpt:latest \
  --entry norm_group=runs/brandubh_ab_norm_group/ckpt:latest \
  --anchors uniform,material,random --games 32 --sims 32 --children 16 \
  --channels 16 --blocks 2 --max-game-len 60 \
  --out runs/brandubh_wc_cross_ladder.json
echo GUMBEL_AB_DONE
