"""The port stands alone: no module of it, and not ``chip_smoke.py``,
imports jax, flax, optax, orbax or the JAX package, and its entry points live on the
CUDA card unless the caller asks for the CPU."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.core.rules import PRESETS

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "alphazeroforhnefatafl_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "alphazeroforhnefatafl_tpu")
FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_names(path: Path):
    """Every absolute module name the file imports, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_file_imports_nothing_of_jax(path):
    bad = [name for name in imported_names(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_whole_port():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for must in ("chip_smoke.py", "alphazeroforhnefatafl_tpu_torch/core/env.py",
                 "alphazeroforhnefatafl_tpu_torch/core/rules.py",
                 "alphazeroforhnefatafl_tpu_torch/ops/step_kernel.py",
                 "alphazeroforhnefatafl_tpu_torch/cli.py",
                 "alphazeroforhnefatafl_tpu_torch/core/symmetry.py",
                 "alphazeroforhnefatafl_tpu_torch/train/learner.py",
                 "alphazeroforhnefatafl_tpu_torch/train/arena.py",
                 "alphazeroforhnefatafl_tpu_torch/train/anchors.py",
                 "alphazeroforhnefatafl_tpu_torch/train/checkpoint.py",
                 "alphazeroforhnefatafl_tpu_torch/train/loop.py",
                 "alphazeroforhnefatafl_tpu_torch/utils/metrics.py",
                 "alphazeroforhnefatafl_tpu_torch/bench.py",
                 "alphazeroforhnefatafl_tpu_torch/utils/profiling.py",
                 "alphazeroforhnefatafl_tpu_torch/core/oracle.py",
                 "alphazeroforhnefatafl_tpu_torch/native/__init__.py",
                 "alphazeroforhnefatafl_tpu_torch/compat/reference_io.py",
                 "alphazeroforhnefatafl_tpu_torch/scripts/train_run.py",
                 "alphazeroforhnefatafl_tpu_torch/scripts/profile_wave.py",
                 "alphazeroforhnefatafl_tpu_torch/scripts/analyze_trace.py",
                 "alphazeroforhnefatafl_tpu_torch/scripts/eval_run.py",
                 "alphazeroforhnefatafl_tpu_torch/scripts/search_ab.py",
                 "alphazeroforhnefatafl_tpu_torch/parallel/launch.py",
                 "alphazeroforhnefatafl_tpu_torch/parallel/mesh.py",
                 "alphazeroforhnefatafl_tpu_torch/parallel/dryrun.py"):
        assert must in names
    # The walk does tell a forbidden import when it sees one.
    sample = ROOT / "tests" / "test_torch_env.py"
    assert any(n.split(".")[0] in FORBIDDEN for n in imported_names(sample))


def test_port_imports_with_the_jax_names_blocked():
    """Every module of the port imports, and a CPU env steps, in a process
    where importing any forbidden name raises."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"  # makes `import name` raise ImportError
        "import alphazeroforhnefatafl_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "from alphazeroforhnefatafl_tpu_torch.core.env import make_env\n"
        "env = make_env('brandubh', 'cpu')\n"
        "s = env.reset_batch(2)\n"
        "a = env.legal_mask_many(s).int().argmax(1)\n"
        "s, info = env.step_many(s, a)\n"
        "assert not bool(info.invalid.any())\n"
        "from alphazeroforhnefatafl_tpu_torch import cli\n"
        "try:\n"
        "    cli.main(['selfplay', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "try:\n"
        "    cli.main(['train', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "for cmd in ('ladder', 'bench', 'play'):\n"
        "    try:\n"
        "        cli.main([cmd, '--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "from alphazeroforhnefatafl_tpu_torch import bench\n"
        "try:\n"
        "    bench.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=ROOT)


def test_env_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tenv._make_env_cached.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenv.make_env("brandubh")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenv.TaflEnv(*PRESETS["brandubh"])
    env = tenv.make_env("brandubh", "cpu")
    assert env.device.type == "cpu" and env.reset_batch(1).board.device.type == "cpu"


def test_train_state_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.train.learner import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = make_network(7, channels=8, blocks=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(net, torch.Generator().manual_seed(0))
    state = init_train_state(net, torch.Generator().manual_seed(0), "cpu")
    assert all(p.device.type == "cpu" for p in state.net.parameters())


@pytest.mark.parametrize(
    "entry, argv",
    [("cli", ["bench"]), ("cli", ["bench", "--device", "cuda"]),
     ("cli", ["play", "--ai", "attacker"]), ("bench", [])],
    ids=["bench", "bench-device-cuda", "play-ai", "bench-module"],
)
def test_cli_bench_and_play_ai_raise_without_a_card(monkeypatch, entry, argv):
    """``bench`` (also as ``python -m ...bench``) and ``play --ai`` run on the
    card unless ``--cpu`` is given: without CUDA they exit with an error
    before measuring or searching."""
    module = importlib.import_module(f"alphazeroforhnefatafl_tpu_torch.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        module.main(argv)
