"""pairs not done at a pass's start summed over the passes
(`ccd.live_pair_passes`), in percent of pairs x passes (`ccd.pair_passes`),
over the span round (portbench/spans.py). None without the program's
recorder."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "ccd.live_pair_passes", "ccd.pair_passes", 100.0)
