"""PyTorch/CUDA port of the tafl AlphaZero stack, for an NVIDIA H100.

The counterpart of ``alphazeroforhnefatafl_tpu``, which stays the reference
it is held against; the port imports nothing of it. This package runs
self-play and the training iteration: the batched env, its two hand-written
CUDA kernels, the policy/value net, serial PUCT search, the self-play
actor, the replay buffer with its device-side batch builder, D4
augmentation, the learner, the gating arena, checkpoints, the loop and the
``selfplay`` and ``train`` commands.

- ``core``   — the batched env (``core/env.py``), D4 symmetries
               (``core/symmetry.py``) and the port's own copies of the
               rules model, the action codec and the FEN codec.
- ``ops``    — the CUDA kernels (``csrc/``) with their plain PyTorch versions
               and the wrappers that dispatch on a tensor's device.
- ``models`` — the policy/value net and the Flax weight converter.
- ``search`` — batched array-tree MCTS.
- ``train``  — self-play actor, replay buffer and batch builder, learner,
               arena, checkpoints and ``run_loop``.
- ``utils``  — the metrics logger.

Entry points live on the CUDA card unless the caller asks for the CPU, and
raise when there is no card. Importing the package needs no CUDA and no
``nvcc``: the kernels are built on the first call that gets a CUDA tensor.
"""

__version__ = "0.1.0"
