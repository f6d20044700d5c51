"""Multi-GPU: one scene's step split over the ranks of a torch.distributed
process group (port of ipc_tpu/parallel/).

  spmd      the active group and the collectives the step calls (sums in
            rank order, minima, "any"); identities with no active group
  sharding  make_group, the JAX package's padding (shard_mesh_data,
            shard_state), a stepper's rank view (shard_stepper), replicate,
            shard_report
  launch    start n rank processes (spawn, file:// rendezvous) and collect
            what each returns
  jobs      the rank processes' work: a rank's stepper and its steps

`python -m ipc_tpu_torch.parallel --ranks 2 --backend gloo --device cpu`
runs the two-box scene's step split over two ranks (the counterpart of
__graft_entry__.dryrun_multichip).
"""
