"""Host milliseconds a self-play move spends outside its search: the span
of one move of the window (the benchmark's loop around
``SelfPlayActor.move``, read-backs and replay writes included) less the
span of its ``MCTS.search`` call, the mean over the window's moves. The
root mask, action selection, env step, policy target and the host work of
``play``."""


def read(run):
    moves, searches = run["spans"]["move"], run["spans"]["search"]
    if not moves or len(moves) != len(searches):
        return None
    extra = [(m1 - m0) - (s1 - s0) for (m0, m1), (s0, s1) in zip(moves, searches)]
    return 1e3 * sum(extra) / len(extra)
