"""Matrix-free ADMM QP solver (the reference hands these QPs to OSQP).

Port of ipc_tpu/qp/admm.py:33-90. The operator-splitting iteration

    minimize    1/2 x^T P x + q^T x
    subject to  A x >= l

    x-update:  (P + sigma I + rho A^T A) x = sigma x_prev - q + A^T(rho z - y)
               by PCG (solver/pcg.py) with the caller's matrix-free P,
               warm-started at the previous x
    z-update:  z = max(A x + y/rho, l)
    y-update:  y = y + rho (A x - z)

stops on OSQP's primal/dual residual pair or after `iters` iterations;
lambda = max(-y, 0) are the multipliers of A x >= l.

A's rows are 12-entry stencil gradients (K,4,3) on vertex ids (K,4): A v
is a gather, A^T w a fixed-order gather-sum over the ids
(ops/scatter.make_dynamic_gather_sum, built once per call), never a
scatter with float atomics. The JAX `lax.while_loop` is a host loop that
reads `done` once per iteration. An ADMM iteration is three bodies on
static buffers (solver/pcg.CapturedBody, GraphedPCG): the x-update's
set-up, PCG's iteration (run while PCG reads its residual above
tolerance) and the z/y update. On CUDA tensors each is a CUDA graph,
captured once per call: the same kernels in the same order as eager
calls, at a few graph launches per iteration instead of ~50 eager
launches per PCG iteration and ~75 per ADMM iteration.

The JAX callers pad the rows to a capacity; the port's are exact-size, so
K can be 0 (every free-fall step): the primal residual is then 0, as JAX's
all-invalid rows give, and the loop stops after one iteration once the
dual residual is below tolerance.
"""

import torch

from ipc_tpu_torch.ops.scatter import make_dynamic_gather_sum
from ipc_tpu_torch.solver.pcg import CapturedBody, GraphedPCG

__all__ = ["admm_qp"]


def admm_qp(P_apply, q, A_rows, A_vids, A_valid, l, precond=None, rho=1e5, sigma=1e-6,
            iters=200, pcg_tol=1e-4, pcg_maxiter=200, eps_abs=1e-6, counters=None,
            vert_sum=None):
    """Solve the QP; returns (x (V,3), lam (K,), iterations).

    P_apply: v (V,3) -> P v (V,3) (matrix-free SPD objective Hessian)
    q: (V,3) linear term
    A_rows: (K,4,3) constraint gradients; A_vids: (K,4) int64 vertex ids;
    A_valid: (K,) bool (invalid rows inert); l: (K,) lower bounds.
    counters: a dict whose "syncs" (host reads: the gather-sum's build, the
    PCG residual tests, one `done` per iteration) and "pcg" (PCG
    iterations) are added to, or None."""
    K = int(A_rows.shape[0])
    V = int(q.shape[0])
    dtype, device = q.dtype, q.device
    counters = {} if counters is None else counters
    counters.setdefault("syncs", 0)
    counters.setdefault("pcg", 0)
    valid = A_valid
    rows = torch.where(valid[:, None, None], A_rows, torch.zeros_like(A_rows))
    l = torch.where(valid, l, torch.zeros_like(l))
    vids = A_vids.to(torch.int64)
    if vert_sum is None:
        vert_sum = make_dynamic_gather_sum(vids.reshape(-1), V)
        counters["syncs"] += vert_sum.host_syncs
    zero = torch.zeros((), dtype=dtype, device=device)
    # 0-d tensors of the dtype, as JAX's jnp.asarray(rho, dtype): a CUDA
    # division by a Python scalar multiplies by its reciprocal instead
    rho = torch.tensor(rho, dtype=dtype, device=device)
    sigma = torch.tensor(sigma, dtype=dtype, device=device)

    def A_apply(v):
        return (rows * v[vids]).sum(dim=(1, 2))

    def AT_apply(w):
        return vert_sum((rows * w[:, None, None]).reshape(-1, 3))

    def kkt(v):
        return P_apply(v) + sigma * v + rho * AT_apply(A_apply(v))

    if precond is None:
        def precond(r):
            return r

    def rhs_of(x, z, y):
        return sigma * x - q + AT_apply(rho * z - y)

    def update(x, z, y):
        """(z, y, done) after the x-update."""
        Ax = A_apply(x)
        z_new = torch.maximum(Ax + y / rho, l)
        y_new = y + rho * (Ax - z_new)
        r_prim = (torch.abs(torch.where(valid, Ax - z_new, torch.zeros_like(Ax))).max()
                  if K else zero)
        r_dual = torch.abs(rho * AT_apply(z_new - z)).max()
        return z_new, y_new, (r_prim < eps_abs) & (r_dual < eps_abs)

    # the x-update's set-up, PCG's body and the z/y update each run on
    # static buffers: on CUDA each is one graph, captured once per call
    solver = GraphedPCG(kkt, precond, q, counters)
    x = solver.state[0]  # zero: the first PCG starts from x = 0
    z = torch.maximum(A_apply(x), l)
    y = torch.zeros((K,), dtype=dtype, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)

    def pre(x, z, y, *pcg_state):
        solver.start(rhs_of(x, z, y), pcg_tol, x, *pcg_state)

    def post(x, z, y, done):
        for buf, val in zip((z, y, done), update(x, z, y)):
            buf.copy_(val)

    pre = CapturedBody(pre, [x, z, y] + solver.state[1:], counters)
    post = CapturedBody(post, [x, z, y, done], counters)
    k = 0
    while k < iters:
        pre.replay()
        counters["pcg"] += solver.iterate(pcg_maxiter)
        post.replay()
        k += 1
        counters["syncs"] += 1
        if bool(done):
            break
    # lambda >= 0 multipliers of Ax >= l (OSQP's y is their negative)
    lam = torch.clamp(-y, min=0.0)
    return x.clone(), lam, k
