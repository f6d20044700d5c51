"""ipc_tpu_torch — the PyTorch/CUDA port of ipc_tpu.

The JAX package `ipc_tpu` is the reference; this package mirrors its layout
(same module paths, same public names), imports nothing of it (it keeps its
own copies, e.g. models/primitives.py), and is held against it on the CPU
in float64 by `tests/test_torch_*.py`. Plain tensor code is PyTorch; the
one Pallas kernel of the JAX package (ops/pallas_hv.py) is a CUDA C++
kernel for Hopper here (csrc/tet_hv.cu, wrapped by ops/tet_hv.py).

What runs today: the production time step (`jit_step.make_step`, the
counterpart of `ipc_tpu.jit_step.make_jit_step`) on the two-box scene
`scenes.build_scene(..., with_contact=...)`: Neo-Hookean elasticity,
backward Euler, the IPC half-space barrier with lagged friction, and with
contact the self-contact barrier, ACCD and self-friction; PCG with the
two-level coarse preconditioner. Beside it the host-path stepper
(`timestepper.IPCStepper.step`, the JAX package's default) with its warm
starts, homotopies, direct solves and mesh-sequence scripts; the scene
driver (`python -m ipc_tpu_torch scene.txt`) runs either. Entry points
run on the card unless the caller passes device="cpu".

Precision policy (the counterpart of `Precision.HIGHEST` throughout the JAX
code): float32 matrix products run in full float32, never TF32. Every
tensor is created with an explicit dtype; both float32 and float64 run.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
