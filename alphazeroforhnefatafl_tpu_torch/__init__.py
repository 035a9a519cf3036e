"""PyTorch/CUDA port of the tafl AlphaZero stack, for an NVIDIA H100.

The counterpart of ``alphazeroforhnefatafl_tpu``, which stays the reference
it is held against. This package runs the self-play path: the batched env,
its two hand-written CUDA kernels, the policy/value net, serial PUCT search,
the replay buffer and the self-play actor with its CLI.

- ``core``   — the batched env (``core/env.py``). Rules, actions, FEN and the
               oracle are imported from the JAX package, whose modules of
               those names use no JAX.
- ``ops``    — the CUDA kernels (``csrc/``) with their plain PyTorch versions
               and the wrappers that dispatch on a tensor's device.
- ``models`` — the policy/value net and the Flax weight converter.
- ``search`` — batched array-tree MCTS.
- ``train``  — replay buffer and self-play actor.

Importing the package needs no CUDA and no ``nvcc``: the kernels are built on
the first call that gets a CUDA tensor.
"""

__version__ = "0.1.0"
