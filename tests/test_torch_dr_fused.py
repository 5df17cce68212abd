"""Per-env joint damping in the fused kernel, float32: the plain version
(`hopper_fused.fused_constraint_plain` with the plan's damping rows)
against the reference's `fused_constraint` whose kernel runs in interpret
mode with its plan for a traced damping (`sm_dyn_damping`, the rows
appended to its packed vec, `:2254`), on tests/test_torch_dr_mega.py's
states and draws, both from the same FK outputs, contacts and warm start
(the port's own solve of the state): qacc, qfrc_constraint and
efc_force_contact within rel 5e-4 of the largest value
(tests/test_torch_fused.py's limits).
"""

import jax
import numpy as np
import pytest

from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import hopper_fused, kinematics
from test_torch_dr_mega import (_jax_dr_plan, check_fields, f32_states,
                                interpret, warm)


@pytest.fixture(scope="module")
def fused32():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td, dd = f32_states(mp)
            interpret(mp)
            td, jd = warm(tm, td, jd)
            d0 = jax.tree_util.tree_map(lambda x: x[0], jd)
            plan = _jax_dr_plan(jm, d0.contact, dd)
            assert plan.sm_dyn_damping
            ref = jax.jit(jax.vmap(lambda d, x: pc.fused_constraint(
                jm.replace(dof_damping=x), d, plan)))(jd, dd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    d = coll.collision(tm, kinematics.kinematics(tm, td))
    return ref, hopper_fused.fused_constraint_plain(tm, d)


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_f32_fused_plain_matches_reference_kernel_with_rows(fused32, field):
    check_fields(*fused32, field)
