"""Bytes and operations of one per-tet Hessian-vector product
out = sum_t P_t^T H_t P_t v, counted from the problem's shapes so that the
count is the same whatever implements it: H (T,12,12), tets (T,4) int32
and v (V,3) read once, out (V,3) written once. An implementation's own
tables (an incidence table, intermediate rows) are not counted."""


def bytes_moved(n_tets, n_verts, itemsize):
    return n_tets * 144 * itemsize + n_tets * 4 * 4 + 2 * n_verts * 3 * itemsize


def flops(n_tets):
    """A 12x12 matrix-vector product per tet (multiply-adds as 2) and the
    four 3-vector adds of its corners."""
    return n_tets * (2 * 144 + 12)
