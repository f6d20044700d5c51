"""tet_hv's share of its bandwidth bound: the product's least time (its
bytes, kernels/tet_hv.py, over the card's HBM bandwidth, peaks.json) over
the profiler's device time of the kernel per operator application, in the
traced part of the window. None without a trace or a launch."""

import json
import os

KERNELS = ("tet_rows_kernel", "vertex_sum_kernel")


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["operator_applications"]:
        return None
    dev_s = sum(v for k, v in t["kernels"].items() if any(n in k for n in KERNELS))
    if dev_s <= 0:
        return None
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "peaks.json")) as f:
        peaks = json.load(f)
    peak = peaks.get(ctx["device_name"], peaks["default"])
    sh = ctx["shapes"]
    nbytes = ctx["kernel"]("tet_hv").bytes_moved(sh["n_tets"], sh["n_verts"], sh["itemsize"])
    least_s = nbytes / peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (dev_s / t["operator_applications"])
