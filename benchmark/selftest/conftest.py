"""Shared set-up of the benchmark's own tests (``python -m pytest
benchmark/selftest``): the benchmark's directories on ``sys.path``, the
``card`` marker, and a self-play cell cut to a size the CPU runs in
seconds."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


#: Every configuration file under ``configs/``, the cell's and those kept
#: for cells to come, with the simulations each is cut to.
CONFIGS = {"copenhagen_r4ab_puct": 8, "copenhagen_cfg4_800sim": 6}


def tiny_cell(config="copenhagen_r4ab_puct", channels=64, blocks=1, batch=16, sims=None,
              children=8):
    """The self-play cell run under configuration ``config``, with its net,
    batch, search and checks cut down."""
    import harness

    ctx = harness.load_cell("selfplay.flagship")
    cfg = copy.deepcopy(harness.load_json(BENCH / "configs" / f"{config}.json"))
    cfg.update(channels=channels, blocks=blocks, selfplay_batch=batch, replay_capacity=4096,
               sims=sims or CONFIGS[config], children=children)
    traffic = dict(ctx["traffic"])
    traffic.update(check_rows=batch // 2, tree_rows=2, start_ply_max=40, trace_seconds=0.1)
    ctx["config"], ctx["traffic"] = cfg, traffic
    return ctx


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
