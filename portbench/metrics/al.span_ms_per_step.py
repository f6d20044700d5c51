"""Host wall ms per step of the program's `al_iter` spans (an iteration
of the moving-DBC augmented Lagrangian, after the read of the AL mode that
opens its `newton` span), inclusive, over the span round
(portbench/spans.py). None without the program's recorder or without such
a span."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_step(ctx, "al_iter")
