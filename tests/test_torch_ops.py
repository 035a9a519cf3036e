"""What of the CUDA kernels' surroundings can be checked without a card: the
table layout and rule struct shared with csrc/tafl_common.cuh, the build's
error path, and the wrappers' device dispatch."""

import re
from pathlib import Path

import pytest
import torch

from alphazeroforhnefatafl_tpu_torch.core.env import make_env
from alphazeroforhnefatafl_tpu_torch.ops import _build, legal_mask, step_kernel

HEADER = Path(_build.CSRC_DIR, "tafl_common.cuh").read_text()


def _define(name):
    m = re.search(rf"#define {name}(\(\w+\))?\s+\(?([^\n]+)", HEADER)
    assert m, name
    return m.group(2).split("//")[0].strip()


def test_table_columns_match_the_header():
    assert int(_define("TAFL_COL_MOVE_END")) == legal_mask.MOVE_COLS
    assert int(_define("TAFL_NUM_COLS")) == step_kernel.NUM_COLS
    for name in ("CORNER", "EDGE", "CC"):
        assert int(_define(f"TAFL_COL_{name}")) == getattr(step_kernel, f"COL_{name}")
    assert _define("TAFL_COL_SPECIAL_HOSTILE").startswith(f"{step_kernel.COL_SPECIAL_HOSTILE} +")
    assert _define("TAFL_COL_CLS_OCC").startswith(f"{step_kernel.COL_CLS_OCC} +")
    assert int(_define("TAFL_NUM_SCALARS")) == len(step_kernel.SCALAR_ROWS)


def test_params_struct_matches_the_header():
    body = re.search(r"struct TaflParams \{(.*?)\};", HEADER, re.S).group(1)
    fields = re.findall(r"int (\w+)(?:\[(\d)\])?;", body)
    want = [(name, int(k) if k else 1) for name, k in fields]
    got = [
        (name, getattr(ctype, "_length_", 1)) for name, ctype in step_kernel.TaflParams._fields_
    ]
    assert got == want


@pytest.mark.parametrize("preset", ["copenhagen", "tablut", "magpie"])
def test_params_and_tables_follow_the_rules(preset):
    env = make_env(preset)
    table, st = step_kernel._static_tables(env)
    p = step_kernel.params_struct(env)
    assert table.shape == (env.n * env.n, step_kernel.NUM_COLS)
    assert p.n == env.n and p.thr_flat == st["thr_flat"]
    assert list(p.move_max_dist)[: p.num_move_classes] == list(st["move_max_dist"])[: p.num_move_classes]
    assert p.rep_n == (3 if preset != "magpie" else 0)
    if preset == "magpie":  # slow soldiers get their own move class
        assert 1 in list(p.move_max_dist)


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc refused the sources' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(_build.KernelBuildError, match="fake nvcc refused"):
        _build.build()
    assert not any((tmp_path / "build").glob("*.so"))


def test_wrappers_take_the_plain_path_only_on_cpu():
    env = make_env("brandubh")
    s = env.reset_batch(2)
    before = (legal_mask.batched_legal_mask.launches, step_kernel.step_arrays.launches)
    env.step_many(s, torch.zeros(2, dtype=torch.int32))
    assert (legal_mask.batched_legal_mask.launches, step_kernel.step_arrays.launches) == before
    meta = s.board.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        legal_mask.batched_legal_mask(env, meta, s.side_to_play.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        step_kernel.step_arrays(env, meta, *[torch.empty(0, device="meta")] * 7)
