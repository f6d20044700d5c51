"""ACCD calls that ran as one kernel launch (`ccd.kernel_calls`), in
percent of the ACCD calls with stencils (`ccd.calls`), over the span round
(portbench/spans.py). None without the program's recorder or without those
counters (a program before the ACCD kernel)."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "ccd.kernel_calls", "ccd.calls", 100.0)
