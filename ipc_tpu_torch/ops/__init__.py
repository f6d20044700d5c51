"""L0 math kernels: batched, branch-free, fixed-shape building blocks.

Submodules (import them directly, as in ipc_tpu.ops):
  barrier       clamped log-barrier b/g/H on squared distances
  compensated   double-float (hi, lo) sums for the f32 line search
  distance      PT/EE squared distances, the EE mollifier and classifiers
  friction      smoothed-Coulomb f0/f1/f2 and tangent bases
  scatter       gather-sum tables (deterministic vertex accumulation)
  spd           SPD projection by eigenvalue clamping
  step_bound    inversion-free step-size bound
  svd3          rotation-consistent 3x3 SVD / fixed-sweep Jacobi eigh
  tet_hv        per-tet Hessian-vector product (CUDA kernel + plain version)
"""
