"""The port's host-side engine against the JAX package's, and the port's env
against the port's own oracle.

- The port's ``core/oracle.py`` plays random games on every preset with the
  same legal plays, invalid-play reasons, captures, boards, repetition
  fields and outcomes as the JAX package's.
- The port's ``native/tafl_engine.cpp`` is the repository's
  ``native/tafl_engine.cpp`` byte for byte from the first ``#include`` on,
  and its ``NativeGame`` agrees with the port's oracle move for move.
- ``compat/reference_io`` gives what the JAX package's gives.
- The port's batched env (its plain CPU path) agrees with the port's oracle
  on random playouts of every preset: the first test of the port that needs
  no JAX env.
- ``cli play`` prints the JAX ``cli play`` transcript for the same input,
  and ``--ai`` makes legal moves.

Every comparison is exact.
"""

import io
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu import cli as jcli
from alphazeroforhnefatafl_tpu.compat import reference_io as jio
from alphazeroforhnefatafl_tpu.core import oracle as joracle
from alphazeroforhnefatafl_tpu.core import rules as jrules
from alphazeroforhnefatafl_tpu_torch import cli as tcli
from alphazeroforhnefatafl_tpu_torch.compat import reference_io as tio
from alphazeroforhnefatafl_tpu_torch.core import actions as A
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.core import fen
from alphazeroforhnefatafl_tpu_torch.core import oracle as toracle
from alphazeroforhnefatafl_tpu_torch.core.rules import PRESETS, Side
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def state_fields(state):
    """A GameState of either package as plain values."""
    reps = state.repetitions
    outcome = state.outcome
    return (
        state.board.tobytes(),
        int(state.side_to_play),
        reps.attacker_reps, reps.defender_reps, reps.attacker_mid_pair, reps.defender_mid_pair,
        [None if r is None else (int(r.side), str(r.play), r.captures) for r in reps.recent],
        reps.first_i,
        state.plays_since_capture,
        state.turn,
        None if outcome is None else (
            None if outcome.winner is None else int(outcome.winner),
            None if outcome.win_reason is None else outcome.win_reason.name,
            None if outcome.draw_reason is None else outcome.draw_reason.name,
        ),
    )


def oracle_mask(logic, state):
    mask = np.zeros(A.num_actions(logic.n), dtype=bool)
    if state.ongoing:
        for play in logic.all_plays(state):
            mask[A.encode_from_tiles(logic.n, play.from_tile, play.to)] = True
    return mask


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_oracle_copy_plays_as_the_jax_oracle(preset):
    assert toracle is not joracle and toracle.GameLogic is not joracle.GameLogic
    rules_t, board_fen = PRESETS[preset]
    rules_j, _ = jrules.PRESETS[preset]
    n = fen.board_from_fen(board_fen).shape[0]
    lt, lj = toracle.GameLogic(rules_t, n), joracle.GameLogic(rules_j, n)
    st = toracle.GameState.from_fen(board_fen, rules_t.starting_side)
    sj = joracle.GameState.from_fen(board_fen, rules_j.starting_side)
    rng = np.random.RandomState(sum(map(ord, preset)))
    for ply in range(160):
        ctx = f"{preset} ply {ply}"
        plays = [str(p) for p in lt.all_plays(st)]
        assert plays == [str(p) for p in lj.all_plays(sj)], ctx
        # Any action of the action space: the same verdict, reason and all.
        for a in rng.randint(0, A.num_actions(n), size=4):
            src, dst = A.decode_to_tiles(n, int(a))
            if not (0 <= dst[0] < n and 0 <= dst[1] < n):
                continue
            vt = lt.validate_play(toracle.Play.from_tiles(src, dst), st)
            vj = lj.validate_play(joracle.Play.from_tiles(src, dst), sj)
            assert (vt and vt.name) == (vj and vj.name), f"{ctx} {src}->{dst}"
        if not plays:
            break
        play = plays[rng.randint(len(plays))]
        st, ct, _ = lt.do_valid_play(toracle.Play.from_str(play), st)
        sj, cj, _ = lj.do_valid_play(joracle.Play.from_str(play), sj)
        assert ct == cj, ctx
        assert state_fields(st) == state_fields(sj), ctx
        if not st.ongoing:
            break


def test_native_engine_source_is_the_repositorys():
    port = (ROOT / "alphazeroforhnefatafl_tpu_torch" / "native" / "tafl_engine.cpp").read_bytes()
    root = (ROOT / "native" / "tafl_engine.cpp").read_bytes()
    code = port.index(b"\n#include") + 1
    assert port[code:] == root[root.index(b"\n#include") + 1:]
    # Above it, only the comment block.
    assert all(line.startswith(b"//") or not line.strip() for line in port[:code].splitlines())


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")


@needs_gxx
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_native_game_matches_the_port_oracle(preset):
    from alphazeroforhnefatafl_tpu_torch.native import NativeGame

    rules, board_fen = PRESETS[preset]
    n = fen.board_from_fen(board_fen).shape[0]
    logic = toracle.GameLogic(rules, n)
    for seed in range(2):
        ostate = toracle.GameState.from_fen(board_fen, rules.starting_side)
        ng = NativeGame(rules, board_fen)
        rng = np.random.RandomState(seed)
        for ply in range(300):
            ctx = f"{preset} seed {seed} ply {ply}"
            omask = oracle_mask(logic, ostate)
            assert np.array_equal(ng.legal_mask(), omask), ctx
            if not omask.any():
                break
            action = int(rng.choice(np.nonzero(omask)[0]))
            ostate, ocaps, _ = logic.do_valid_play(
                toracle.Play.from_tiles(*A.decode_to_tiles(n, action)), ostate
            )
            ng.step(action)
            assert set(ng.last_captures()) == ocaps, ctx
            assert np.array_equal(ng.board(), ostate.board), ctx
            assert (ng.reps(0), ng.reps(1)) == (
                ostate.repetitions.attacker_reps, ostate.repetitions.defender_reps
            ), ctx
            assert ng.side_to_play == int(ostate.side_to_play), ctx
            assert ng.result == oracle_result(ostate)[0], ctx
            if not ostate.ongoing:
                break
    with pytest.raises(ValueError):
        NativeGame(rules, board_fen).step(0)  # (0, 0) is an empty corner: no piece
    with pytest.raises(ValueError):
        NativeGame(rules, "3t3/3t2/7")  # ragged FEN


def test_reference_io_copy_matches_jax(tmp_path):
    assert tio is not jio
    game_t = toracle.Game(*PRESETS["brandubh"])
    game_j = joracle.Game(*jrules.PRESETS["brandubh"])
    for play in ("d1-c1", "d3-a3", "d2-a2"):  # the third captures
        game_t.do_play(toracle.Play.from_str(play))
        game_j.do_play(joracle.Play.from_str(play))
    moves_t, moves_j = tio.get_all_possible_moves(game_t), jio.get_all_possible_moves(game_j)
    assert [str(m) for m in moves_t] == [str(m) for m in moves_j] and moves_t
    # Validity over the side to move's plays and the other side's.
    other = toracle.GameLogic(game_t.logic.rules, game_t.logic.n).all_plays(
        game_t.state, Side(1 - int(game_t.state.side_to_play))
    )
    probe = moves_t + other
    got = tio.validate_moves(game_t, probe)
    assert got == jio.validate_moves(game_j, [joracle.Play.from_str(str(m)) for m in probe])
    assert 0 in got and 1 in got
    for fix in (False, True):
        m = tio.board_to_matrix(game_t.state.board, fix_side_blindness=fix)
        assert np.array_equal(m, jio.board_to_matrix(game_j.state.board, fix_side_blindness=fix))
    # The bounded file: a bound of lines, as the reference's, evicts the
    # oldest lines once the file holds 12 (``read_entries`` then misreads
    # it, in both packages alike); a larger bound keeps every entry.
    for bound in (12, 1000):
        for module, name in ((tio, f"port{bound}.txt"), (jio, f"jax{bound}.txt")):
            for i in range(4):
                module.write_to_file(str(tmp_path / name), m, got, i, -i, max_entries=bound)
        assert (tmp_path / f"port{bound}.txt").read_bytes() == (tmp_path / f"jax{bound}.txt").read_bytes()
    got_entries = tio.read_entries(str(tmp_path / "port1000.txt"), side_len=7)
    want_entries = jio.read_entries(str(tmp_path / "jax1000.txt"), side_len=7)
    assert len(got_entries) == len(want_entries) == 4
    for g, w in zip(got_entries, want_entries):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]) and g[2:] == w[2:]


def oracle_result(state):
    """(result code, reason code) of the port's env for an oracle state."""
    o = state.outcome
    if o is None:
        return tenv.ONGOING, tenv.R_NONE
    if o.winner is None:
        return tenv.DRAW, {0: tenv.R_DRAW_REPETITION, 1: tenv.R_DRAW_NO_PLAYS}[int(o.draw_reason)]
    return int(o.winner), int(o.win_reason)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_port_env_matches_the_port_oracle(preset):
    """Four random games a preset in one batch, move for move: the fused
    next-player mask, captures, boards, repetition counts, turn and
    outcome. A finished game's lane stays frozen."""
    rules, board_fen = PRESETS[preset]
    env = tenv.make_env(preset, "cpu")
    n, B = env.n, 4
    logic = toracle.GameLogic(rules, n)
    games = [toracle.GameState.from_fen(board_fen, rules.starting_side) for _ in range(B)]
    state = env.reset_batch(B)
    mask = env.legal_mask_many(state).numpy()
    rng = np.random.RandomState(sum(map(ord, preset)) + 1)
    for ply in range(120):
        live = [b for b in range(B) if games[b].ongoing]
        if not live:
            break
        actions = np.zeros(B, np.int32)
        for b in live:
            ctx = f"{preset} game {b} ply {ply}"
            assert np.array_equal(mask[b], oracle_mask(logic, games[b])), ctx
            actions[b] = rng.choice(np.nonzero(mask[b])[0])
        state, info = env.step_many(state, torch.from_numpy(actions))
        mask = info.legal_mask.numpy()
        for b in live:
            ctx = f"{preset} game {b} ply {ply}"
            play = toracle.Play.from_tiles(*A.decode_to_tiles(n, int(actions[b])))
            games[b], caps, _ = logic.do_valid_play(play, games[b])
            g = games[b]
            assert not bool(info.invalid[b]), ctx
            assert {tuple(t) for t in np.argwhere(info.captures[b].numpy())} == caps, ctx
            assert np.array_equal(state.board[b].numpy(), g.board), ctx
            assert state.reps[b].tolist() == [g.repetitions.attacker_reps, g.repetitions.defender_reps], ctx
            assert state.mid_pair[b].tolist() == [g.repetitions.attacker_mid_pair,
                                                  g.repetitions.defender_mid_pair], ctx
            assert int(state.plays_since_capture[b]) == g.plays_since_capture, ctx
            assert int(state.turn[b]) == g.turn, ctx
            assert int(state.side_to_play[b]) == int(g.side_to_play), ctx
            assert (int(state.result[b]), int(state.reason[b])) == oracle_result(g), ctx
            assert bool(state.terminated[b]) == (not g.ongoing), ctx


#: A scripted Brandubh game that ends in a defender win by escape at the
#: twelfth move, with a malformed move, an illegal one and an undo mixed in.
WIN_SCRIPT = ("d1-c1 d3-a3 xyz a1-b1 d2-a2 undo d2-a2 e4-e2 c1-b1 d4-e4 b1-c1 "
              "e4-e3 c1-b1 e3-g3 b1-c1 g3-g1").split()


def transcript(main, argv, lines, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(f"{l}\n" for l in lines)))
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize(
    "preset, lines",
    [
        ("brandubh", WIN_SCRIPT),
        ("brandubh", ["d1-c1", "undo", "undo", "d1-c1", "d3-a3", "quit"]),
        ("copenhagen", ["d1-d2", "f4-f3"]),  # ends on end of input
    ],
    ids=["win", "quit", "eof"],
)
def test_cli_play_prints_the_jax_transcript(preset, lines, monkeypatch, capsys):
    argv = ["play", "--preset", preset]
    got = transcript(tcli.main, argv, lines, monkeypatch, capsys)
    assert got == transcript(jcli.main, argv, lines, monkeypatch, capsys)
    assert got.count("Board:") >= 3
    if lines is WIN_SCRIPT:
        assert "Game over. Winner is Defender (KING_ESCAPED)." in got
        assert got.count("Invalid move") == 2


def test_cli_play_ai_makes_legal_moves(monkeypatch, capsys):
    """``--ai attacker`` on the CPU: the AI opens, one human move, the AI's
    reply, then ``quit``; both AI moves are legal under the port's oracle."""
    out = transcript(tcli.main, ["play", "--ai", "attacker", "--cpu", "--sims", "4"],
                     ["c4-c5", "quit"], monkeypatch, capsys)
    assert "Invalid move" not in out
    ai = re.findall(r"^AI plays (\S+)$", out, flags=re.M)
    assert len(ai) == 2
    game = toracle.Game(*PRESETS["brandubh"])
    for play in (ai[0], "c4-c5", ai[1]):
        assert game.logic.validate_play(toracle.Play.from_str(play), game.state) is None, play
        game.do_play(toracle.Play.from_str(play))
