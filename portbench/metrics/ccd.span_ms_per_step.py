"""Host wall ms per step of the program's `ccd` spans (SelfContact.ccd_alpha:
ACCD's passes over the PT and EE candidates), inclusive, a span nested in
one of the same name counted once, over the span round (portbench/spans.py).
None without the program's recorder or without such a span."""

from portbench import spans


def read(ctx):
    return spans.span_ms_per_step(ctx, "ccd")
