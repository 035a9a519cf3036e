"""The net's host issue: the mean length of the program's ``net/forward``
span (``PolicyValueNet.forward``, whole) over the forwards inside the
traced moves, in milliseconds; a program without the span reads
nothing."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    lo, hi = t["window"]
    spans = [e - s for name, s, e in t["host"] if name == "net/forward" and lo <= s and e <= hi]
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3
