"""The device's idle share of the traced step: 1 - (union of its kernel
intervals under the profiler) / (the same step's wall time without the
profiler), in percent. The profiler slows the host, not the kernels, so
the plain wall time is the step's own. None without a trace."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["wall_plain_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_plain_s"])
