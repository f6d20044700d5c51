"""portbench: the benchmark of ipc_tpu_torch's device time step on one GPU.

Run a cell with `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (README.md).
"""
