"""The port's counterparts of the JAX package's tools (tools/ at the
repository's root), run as `python -m ipc_tpu_torch.tools.<name>`; each
module keeps its JAX tool's file name:

* paper_battery: every paper scene file a few steps in a child process
  under a hard timeout, with the solver's invariants checked
  (PASS/FAIL/SKIP/TIMEOUT records);
* batch: every scene file of a folder through sim.run_scene;
* battery_summary, gen_status_battery: the tally and the STATUS.md table
  from the battery JSON;
* twist_scenes: the paper's mat-twist scene files over meshes written from
  models/primitives.mat (no JAX counterpart: the reference's meshes are
  not part of this repository).

Not ported: the XLA and TPU tools (compile_ab, mem_probe, mem_breakdown,
tpu_watchdog_probe); profile_step's counterpart is ipc_tpu_torch/profile_step.py.
"""
