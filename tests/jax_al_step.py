"""JAX's jitted step with the port's warm start after the moving-DBC AL.

Both packages warm-start each Newton iteration's PCG from the previous
direction. The port starts a projected iteration that follows AL
iterations with the direction's DBC rows zeroed (ipc_tpu_torch/jit_step.py);
the JAX loop carries the AL direction's rows into it, so its first
projected line search moves the held handles on along them and fails. The
tests hold the port to JAX's loop run one iteration per dispatch through
make_jit_step's bounded-dispatch entry points (`burst=`), with the carried
direction's DBC rows zeroed before each projected iteration: the JAX
package's own arithmetic, started as the port starts it. Without the
zeroing (`zero_dbc=False`) it is make_jit_step's fused step bit for bit
(tests/test_torch_script_step.py).
"""

import jax.numpy as jnp
import numpy as np

from ipc_tpu.jit_step import make_jit_step

__all__ = ["jax_al_step"]


def jax_al_step(stepper, zero_dbc=True):
    """`state -> (state, JitStepStats)` of make_jit_step(stepper), the
    Newton loop one iteration per dispatch, with (zero_dbc) or without the
    port's warm start after the AL (module docstring)."""
    begin, run_burst, finish, max_newton = make_jit_step(stepper, donate=False, burst=1)
    dbc = jnp.asarray(np.asarray(stepper.mesh.dbc_mask))[:, None]

    def step(state):
        state, aux_out, script_scale, pa, carry = begin(state)
        while not bool(carry["done"]) and int(carry["k"]) < max_newton:
            if zero_dbc and "al" in carry and not bool(carry["al"]):
                carry = dict(carry, dx=jnp.where(dbc, jnp.zeros_like(carry["dx"]),
                                                 carry["dx"]))
            carry = run_burst(pa, carry)
        return finish(state, aux_out, script_scale, pa, carry)

    return step
