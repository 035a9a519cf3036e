"""The benchmark's frozen copy of the tafl rules: ``oracle.py``, ``rules.py``,
``fen.py`` and ``actions.py`` as ``alphazeroforhnefatafl_tpu_torch/core`` had
them when the benchmark was defined. The pure-Python oracle is the plain
reference of the rules (legal moves, captures, outcomes, repetitions) that
judges the program's env and kernels; it imports nothing of the program, and
later changes to the program cannot move it."""
