"""Positions self-play wrote per second of the host's clock: the window's
positions (512 a move) over the seconds from its start to the end of its
last move, the first to end after ``--seconds``. In a ``--trace 1`` run the
window is not traced; its search spans end with a sync."""


def read(run):
    if run["window_s"] <= 0:
        return None
    return run["positions"] / run["window_s"]
