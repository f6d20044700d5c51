"""Host wall ms per step of the program's `script` spans (the scripted
prologue: the scripted move, its filters, broad phase, CCD and
backtracking), inclusive, a span nested in one of the same name counted
once, over the span round (portbench/spans.py). None without the program's
recorder or without such a span."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_step(ctx, "script")
