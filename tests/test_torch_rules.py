"""The port's own copies of ``core/rules.py``, ``core/fen.py``,
``core/actions.py`` and ``utils/metrics.py`` against the JAX package's: the
same enums, the same presets field for field, the same FEN codec, the same
action codec and the same metrics lines. Everything is an integer or a
string, so the comparisons are exact."""

import dataclasses
import enum
import io
import json

import numpy as np
import pytest

from alphazeroforhnefatafl_tpu.core import actions as jactions
from alphazeroforhnefatafl_tpu.core import fen as jfen
from alphazeroforhnefatafl_tpu.core import rules as jrules
from alphazeroforhnefatafl_tpu.utils import metrics as jmetrics
from alphazeroforhnefatafl_tpu_torch.core import actions as tactions
from alphazeroforhnefatafl_tpu_torch.core import fen as tfen
from alphazeroforhnefatafl_tpu_torch.core import rules as trules
from alphazeroforhnefatafl_tpu_torch.utils import metrics as tmetrics

ENUMS = sorted(
    name for name, obj in vars(jrules).items()
    if isinstance(obj, type) and issubclass(obj, enum.Enum) and obj.__module__ == jrules.__name__
)


def plain(obj):
    """A dataclass, enum or tuple of the rules model as nested plain values,
    so that objects of the two packages compare by content."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name, int(obj.value))
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return [plain(x) for x in obj]
    return obj


def test_the_copies_are_not_the_jax_packages_modules():
    assert trules is not jrules and trules.Ruleset is not jrules.Ruleset
    assert ENUMS == sorted(
        name for name, obj in vars(trules).items()
        if isinstance(obj, type) and issubclass(obj, enum.Enum) and obj.__module__ == trules.__name__
    )
    assert len(ENUMS) >= 9


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_and_values_match(name):
    want, got = getattr(jrules, name), getattr(trules, name)
    assert [(m.name, int(m.value)) for m in got] == [(m.name, int(m.value)) for m in want]


def test_cell_codes_and_piece_classes_match():
    for name in ("EMPTY", "CELL_ATT", "CELL_DEF", "CELL_KING"):
        assert getattr(trules, name) == getattr(jrules, name)
    assert plain(trules.PIECE_CLASSES) == plain(jrules.PIECE_CLASSES)
    for cell in range(4):
        assert plain(trules.cell_to_piece(cell)) == plain(jrules.cell_to_piece(cell))
    for piece in trules.PIECE_CLASSES:
        assert trules.piece_to_cell(piece) == jrules.piece_to_cell(
            jrules.Piece(jrules.PieceType(int(piece.piece_type)), jrules.Side(int(piece.side)))
        )


@pytest.mark.parametrize("preset", sorted(jrules.PRESETS))
def test_preset_rules_and_board_match(preset):
    assert sorted(trules.PRESETS) == sorted(jrules.PRESETS)
    (want_rules, want_fen), (got_rules, got_fen) = jrules.PRESETS[preset], trules.PRESETS[preset]
    assert isinstance(got_rules, trules.Ruleset)
    assert [f.name for f in dataclasses.fields(got_rules)] == [
        f.name for f in dataclasses.fields(want_rules)
    ]
    assert plain(got_rules) == plain(want_rules)
    assert got_fen == want_fen
    # Per-class membership, as the env reads it.
    for field in ("may_enter_corners", "slow_pieces"):
        assert getattr(got_rules, field).class_tuple() == getattr(want_rules, field).class_tuple()
    assert np.array_equal(tfen.board_from_fen(got_fen), jfen.board_from_fen(want_fen))


@pytest.mark.parametrize("preset", sorted(jrules.PRESETS))
def test_fen_round_trip_matches(preset):
    text = trules.PRESETS[preset][1]
    board = tfen.board_from_fen(text)
    assert board.dtype == jfen.board_from_fen(text).dtype == np.int8
    assert tfen.board_to_fen(board) == jfen.board_to_fen(board) == text
    assert tfen.board_to_display_str(board) == jfen.board_to_display_str(board)
    # A position that is not a start board: every third piece removed.
    thinned = board.copy()
    cells = np.argwhere(thinned != 0)[::3]
    thinned[cells[:, 0], cells[:, 1]] = 0
    assert tfen.board_to_fen(thinned) == jfen.board_to_fen(thinned)
    assert np.array_equal(tfen.board_from_fen(tfen.board_to_fen(thinned)), thinned)


@pytest.mark.parametrize("n", [7, 11])
def test_action_codec_matches_over_every_action(n):
    assert tactions.num_actions(n) == jactions.num_actions(n) == n * n * 4 * (n - 1)
    assert tactions.DIR_OFFSETS == jactions.DIR_OFFSETS
    acts = np.arange(tactions.num_actions(n))
    got, want = tactions.decode(n, acts), jactions.decode(n, acts)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(tactions.encode(n, *got), acts)
    assert np.array_equal(tactions.encode(n, *got), jactions.encode(n, *want))
    for g, w in zip(tactions.to_tile(*got), jactions.to_tile(*want)):
        assert np.array_equal(g, w)
    # The tile-pair forms, on every action that stays on the board.
    tr, tc = tactions.to_tile(*got)
    on_board = (tr >= 0) & (tr < n) & (tc >= 0) & (tc < n)
    for a in acts[on_board][:: 7]:
        src, dst = tactions.decode_to_tiles(n, int(a))
        assert (src, dst) == jactions.decode_to_tiles(n, int(a))
        assert tactions.encode_from_tiles(n, src, dst) == int(a) == jactions.encode_from_tiles(n, src, dst)


def _logged_lines(module, tmp_path, name):
    """The lines a MetricsLogger of ``module`` writes, to its stream and to
    its file, for one fixed sequence of calls (elapsed time dropped)."""
    stream, path = io.StringIO(), tmp_path / name
    log = module.MetricsLogger(stream=stream, jsonl_path=str(path))
    log.scalar("resume/iteration", 2)  # no step yet: joins the next step's line
    log.scalar("selfplay/games", 7, step=2)
    log.scalar("train/loss", 1.23456789, step=2)
    log.scalar("train/loss", 1.5, step=2)  # overwrites
    log.scalar("arena/score", 0.5, step=3)  # another step: flushes step 2 first
    log.scalar("train/loss", float("nan"), step=3)
    log.scalar("train/grad_norm", float("inf"), step=3)
    log.flush(step=3)
    log.flush()  # nothing pending: no line
    log.scalar("stop/deadline_reached", 1.0)
    log.flush()
    log.close()
    lines = [json.loads(l) for l in stream.getvalue().splitlines()]
    assert lines == [json.loads(l) for l in path.read_text().splitlines()]
    for line in lines:
        assert isinstance(line.pop("t"), float)
    return lines


def test_metrics_logger_copy_matches(tmp_path):
    assert tmetrics is not jmetrics
    got = _logged_lines(tmetrics, tmp_path, "port.jsonl")
    assert got == _logged_lines(jmetrics, tmp_path, "jax.jsonl")
    assert got == [
        {"step": 2, "resume/iteration": 2.0, "selfplay/games": 7.0, "train/loss": 1.5},
        {"step": 3, "arena/score": 0.5, "train/loss": "nan", "train/grad_norm": "inf"},
        {"step": None, "stop/deadline_reached": 1.0},
    ]
