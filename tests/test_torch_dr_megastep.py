"""Per-env joint damping in the megastep, float32: the plain version
(`hopper_mega.mega_step_n_plain`, two staged RK4 substeps with the plan's
damping rows) against the reference's interpret-mode megastep kernel with
its operand rows (`mega_step_n`, `:2967`), on tests/test_torch_dr_mega.py's
states and draws: the increments of qpos and qvel and the carried warm
start within rel 5e-4 of the largest value (tests/test_torch_megastep.py's
limits).
"""

import jax
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu_torch.ops import forward
from test_torch_dr_mega import f32_states, interpret, rel_err

N = 2


@pytest.fixture(scope="module")
def step32():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td, dd = f32_states(mp)
            interpret(mp)
            ref = jax.jit(jax.vmap(lambda d, x: jfwd.step_n(
                jm.replace(dof_damping=x), d, N)))(jd, dd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return ref, forward.step_n(tm, td, N), td


@pytest.mark.parametrize("field", ["qpos", "qvel", "qacc_warmstart"])
def test_f32_megastep_plain_matches_reference_kernel_with_rows(step32,
                                                               field):
    ref, got, td = step32
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert rel_err(g, r) < 5e-4
