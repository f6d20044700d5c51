"""AL episodes that ended with the handles' scripted move completed
(`al.completed`), in percent of the episodes started (`al.episodes`), over
the span round (portbench/spans.py); the others ended on a stalled line
search (`al.stalled`) or at the iteration cap (`al.capped`). None without
the program's AL counters or without an episode in the round."""

from portbench import spans


def read(ctx):
    r = spans.span_round(ctx)
    if r is None:
        return None
    c = r["counters"]
    if not c.get("al.episodes"):
        return None
    return 100.0 * c.get("al.completed", 0) / c["al.episodes"]
