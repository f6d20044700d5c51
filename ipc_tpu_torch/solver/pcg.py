"""Matrix-free preconditioned conjugate gradient.

Port of ipc_tpu/solver/pcg.py:30-94. The `lax.while_loop` becomes a Python
loop: each iteration reads the squared residual back to the host once to
test termination (the one host sync per PCG iteration). `pcg_start` is
the set-up and `pcg_iteration` one iteration; `pcg` loops over them.

`GraphedPCG` runs the same two functions on static buffers, for an
operator applied many times over (the QP path's ADMM solves one system
per ADMM iteration). On CUDA tensors the iteration is captured once into
a CUDA graph and replayed (`CapturedBody`): the same kernels in the same
order on the same values, so the same iterates bit for bit, at one graph
launch per iteration instead of the ~50 eager launches of the body. On
other devices the same code runs eagerly.
"""

import torch

from ipc_tpu_torch.ops import launch_counts

__all__ = ["pcg", "pcg_start", "pcg_iteration", "GraphedPCG", "CapturedBody",
           "block_jacobi_inverse", "apply_block_precond"]


def _dot(a, b):
    return (a * b).sum()


def _nonzero_or_one(t):
    return torch.where(t != 0.0, t, torch.ones_like(t))


def pcg_start(operator, precond, b, x, tol):
    """PCG's set-up for A x = b from the iterate x: (r, p, r.z, r.r, the
    stopping threshold on r.r)."""
    atol2 = tol * tol * torch.clamp(_dot(b, b), min=1e-300)
    r = b - operator(x)
    p = precond(r)
    return r, p, _dot(r, p), _dot(r, r), atol2


def pcg_iteration(operator, precond, x, r, p, rz):
    """One PCG iteration: the next (x, r, p, r.z, r.r)."""
    Ap = operator(p)
    alpha = rz / _nonzero_or_one(_dot(p, Ap))
    x = x + alpha * p
    r = r - alpha * Ap
    z = precond(r)
    rz_new = _dot(r, z)
    beta = rz_new / _nonzero_or_one(rz)
    return x, r, z + beta * p, rz_new, _dot(r, r)


def pcg(operator, b, precond, x0=None, tol=1e-5, maxiter=1000):
    """Solve A x = b with preconditioned CG.

    operator: v -> A v; precond: r -> M^-1 r.
    Returns (x, iters (int), rel_residual (0-d tensor))."""
    x = torch.zeros_like(b) if x0 is None else x0
    r, p, rz, rr, atol2 = pcg_start(operator, precond, b, x, tol)
    k = 0
    while k < maxiter and bool(rr > atol2):
        x, r, p, rz, rr = pcg_iteration(operator, precond, x, r, p, rz)
        k += 1
    rel = torch.sqrt(rr / torch.clamp(_dot(b, b), min=1e-300))
    return x, k, rel


class CapturedBody:
    """`body(*buffers)`, which reads tensors and writes only into `buffers`,
    run again by each `replay()` on the buffers' current values.

    On CUDA tensors the body is captured once into a CUDA graph, and a
    replay launches the graph. Before the capture the body runs once on
    copies of the buffers, on the capture stream (eager launches, counted
    as such), so that every library it calls is set up outside the
    capture. The capture itself runs nothing: the operator applications it
    recorded in counters["operator"] are taken back, and each replay adds
    them, and the kernel launches the capture recorded
    (ops/launch_counts). On other devices `replay()` calls the body."""

    def __init__(self, body, buffers, counters):
        self.body, self.buffers, self.graph = body, buffers, None
        if buffers[0].device.type != "cuda":
            return
        side = torch.cuda.Stream(buffers[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(*[t.clone() for t in buffers])
        ops0, kernels0 = counters["operator"], launch_counts.captured()
        # capture_begin/end, not the torch.cuda.graph context: that one also
        # runs gc.collect() and empties the allocator's cache at every
        # capture, and an ADMM solve captures at every call
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                body(*buffers)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        self.ops = counters["operator"] - ops0
        self.kernels = tuple(n - n0 for n, n0 in zip(launch_counts.captured(), kernels0))
        counters["operator"] = ops0
        self.counters = counters

    def replay(self):
        if self.graph is None:
            self.body(*self.buffers)
            return
        self.graph.replay()
        self.counters["operator"] += self.ops
        launch_counts.count_replay(self.kernels)


class GraphedPCG:
    """`pcg` on static buffers, its iteration a CUDA graph on CUDA tensors.

    One instance serves one operator and preconditioner (fixed tensors
    behind them) over many right-hand sides. `state` holds its buffers:
    the iterate, residual, direction, r.z, r.r and the stopping threshold.
    `start(b, tol, *state)` writes `pcg_start` from the iterate in the
    buffer (a caller may capture it into its own graph), `iterate(maxiter)`
    runs `pcg`'s loop of `pcg_iteration` in a `CapturedBody` made at the
    first iteration it needs: the iterate in `state[0]` and the count are
    those `pcg` returns from the same x0.
    counters: a dict whose "operator" counts the operator's applications
    (the operator adds one per eager call) and "syncs" the residual tests,
    or None."""

    def __init__(self, operator, precond, like, counters=None):
        self.operator = operator
        self.precond = precond
        self.counters = {} if counters is None else counters
        self.counters.setdefault("operator", 0)
        self.counters.setdefault("syncs", 0)
        zero = torch.zeros((), dtype=like.dtype, device=like.device)
        self.state = [torch.zeros_like(like), torch.zeros_like(like), torch.zeros_like(like),
                      zero.clone(), zero.clone(), zero.clone()]
        self.body = None

    def start(self, b, tol, x, r, p, rz, rr, atol2):
        """`pcg_start` for A x = b from the iterate in x, into the buffers."""
        for buf, val in zip((r, p, rz, rr, atol2),
                            pcg_start(self.operator, self.precond, b, x, tol)):
            buf.copy_(val)

    def _body(self, x, r, p, rz, rr):
        for buf, val in zip((x, r, p, rz, rr),
                            pcg_iteration(self.operator, self.precond, x, r, p, rz)):
            buf.copy_(val)

    def iterate(self, maxiter):
        """`pcg`'s loop from the started buffers; returns the iterations."""
        rr, atol2 = self.state[4:]
        k = 0
        while k < maxiter:
            self.counters["syncs"] += 1
            if not bool(rr > atol2):
                break
            if self.body is None:
                self.body = CapturedBody(self._body, self.state[:5], self.counters)
            self.body.replay()
            k += 1
        return k


def block_jacobi_inverse(diag_blocks, reg=0.0):
    """Invert (V,3,3) per-vertex diagonal blocks (closed-form adjugate
    inverse; identity on singular blocks)."""
    A = diag_blocks
    if reg:
        A = A + reg * torch.eye(3, dtype=A.dtype, device=A.device)[None]
    c0 = torch.linalg.cross(A[:, :, 1], A[:, :, 2], dim=1)
    c1 = torch.linalg.cross(A[:, :, 2], A[:, :, 0], dim=1)
    c2 = torch.linalg.cross(A[:, :, 0], A[:, :, 1], dim=1)
    det = (A[:, :, 0] * c0).sum(dim=1)
    adjT = torch.stack([c0, c1, c2], dim=1)  # rows of the adjugate
    ok = torch.abs(det) > 1e-300
    inv = adjT / torch.where(ok, det, torch.ones_like(det))[:, None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A)
    return torch.where(ok[:, None, None], inv, eye)


def apply_block_precond(inv_blocks, r):
    """Apply (V,3,3) inverse blocks to a (V,3) residual."""
    return torch.einsum("vij,vj->vi", inv_blocks, r)
