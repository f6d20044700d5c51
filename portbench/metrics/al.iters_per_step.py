"""Iterations of the moving-DBC augmented Lagrangian (the program's
`al.iters`) per step of the span round (portbench/spans.py). None without
the program's AL counters or without an AL episode in the round."""

from portbench import spans


def read(ctx):
    r = spans.span_round(ctx)
    if r is None or not r["steps"] or "al.iters" not in r["counters"]:
        return None
    return r["counters"]["al.iters"] / r["steps"]
