"""L0 math kernels: batched, branch-free, fixed-shape building blocks.

Submodules (import them directly, as in ipc_tpu.ops):
  barrier     clamped log-barrier b/g/H on squared distances
  compensated double-float (hi, lo) sums for the f32 line search
  friction    smoothed-Coulomb f0/f1/f2 (tangent bases wait for slice 2)
  scatter     static-topology gather-sum (deterministic vertex accumulation)
  spd         SPD projection by eigenvalue clamping
  step_bound  inversion-free step-size bound
  svd3        rotation-consistent 3x3 SVD / fixed-sweep Jacobi eigh
  tet_hv      per-tet Hessian-vector product (CUDA kernel + plain version)

Not ported yet: distance (slice 2, self-contact).
"""
