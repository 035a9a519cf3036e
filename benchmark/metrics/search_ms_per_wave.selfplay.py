"""Host milliseconds of one simulation wave: the spans of the window's
``MCTS.search`` calls (ended by a synchronisation in the traced run) over
their waves, ``num_simulations / leaves_per_wave`` each."""


def read(run):
    searches = run["spans"]["search"]
    if not searches:
        return None
    total = sum(s1 - s0 for s0, s1 in searches)
    return 1e3 * total / (len(searches) * run["waves_per_move"])
