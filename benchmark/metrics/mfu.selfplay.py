"""The self-play window's share of the card's bf16 peak: the analytic
FLOPs of the evaluations the configuration asks for (positions x
(num_simulations + 1) x the net's FLOPs an evaluation) over the window's
seconds x the peak x the cards. The count is the same whatever implements
the search."""


def read(run):
    peak = run["peak"]
    if peak is None or run["window_s"] <= 0:
        return None
    flops = run["positions"] * run["evals_per_position"] * run["flops_per_eval"]
    return 100.0 * flops / (run["window_s"] * peak["bf16_flops_per_s"] * run["chips"])
