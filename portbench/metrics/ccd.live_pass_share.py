"""ACCD passes that begin with a pair of their call not done
(`ccd.live_passes`), in percent of the passes run (`ccd.passes`), over the
span round (portbench/spans.py). None without the program's recorder."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "ccd.live_passes", "ccd.passes", 100.0)
