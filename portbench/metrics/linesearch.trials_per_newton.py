"""line-search trials (energy evaluations at trial points, the program's
`linesearch.trials`) per Newton iteration that took a line search
(`newton.iters`), over the span round (portbench/spans.py). None without the
program's recorder."""

from portbench import spans


def read(ctx):
    return spans.counter_ratio(ctx, "linesearch.trials", "newton.iters", 1.0)
