"""The port's run drivers: the counterparts of the root ``scripts/``.

Each module has ``main(argv=None) -> int`` and runs as ``python -m
alphazeroforhnefatafl_tpu_torch.scripts.<name>`` with the flags, defaults,
output lines and files of its JAX counterpart, plus ``--device`` (default
``cuda``) and ``--cpu``; without a card and without ``--cpu`` it exits with
an error. Flags that name a TPU mechanism the port does not have
(``--search-chunk``, ``--scan-moves``, ``--chunk``, ``--node-read``,
``--unroll``) are accepted so that every recorded command line still runs,
change nothing, and print one notice on stderr when given a value other than
their default.
"""

from __future__ import annotations

import argparse
import sys


def add_device_flags(p: argparse.ArgumentParser) -> None:
    """``--device`` and ``--cpu``, as the CLI has them."""
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")


def note_tpu_flags(p: argparse.ArgumentParser, args: argparse.Namespace, *dests: str) -> None:
    """One notice on stderr for each flag of ``dests`` given a value other
    than its default: the port has no such mechanism and ignores it."""
    for dest in dests:
        value = getattr(args, dest)
        if value != p.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            print(
                f"notice: {flag} {value} is ignored: it sets a TPU mechanism that "
                "the PyTorch port does not have",
                file=sys.stderr,
            )
