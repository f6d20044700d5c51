"""QP/SQP constraint-solver comparison path (reference constraintSolver
QP | SQP; src/CollisionObject/CollisionConstraints.*, Optimizer.cpp QP
plumbing :627-922, fullyImplicit :1340-1515).

Port of ipc_tpu/qp/: the constraint families (constraints.py), the
matrix-free ADMM QP solver (admm.py) and the QP/SQP stepper on the
host-path stepper (stepper.py)."""
