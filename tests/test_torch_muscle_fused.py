"""The port's staged path on the muscle humanoid (`LMT_MEGA=0`, float32, on
the CPU): the staged com_pos, tendon, velocity, passive and actuation stages
and `hopper_fused.fused_constraint_plain` in the non-smooth vec layout,
against the JAX package's staged forward, whose constraint stage is
`pallas_constraint.fused_constraint` (`_fused_batched`, the non-smooth
layout of `_forward_env_block`) in interpret mode.

Small muscle fixture, 8 envs (`test_torch_fixture.mega_states(muscle=True)`),
both warm-started from the port's converged solve, the reference's kernels
run as `test_torch_muscle_mega.reference_mode` runs them. qacc,
qfrc_constraint, efc_force_contact and euler_dv within rel 5e-4 of the
largest value.
"""

import pytest

from test_torch_muscle_mega import close, forwards


@pytest.fixture(scope="module")
def outputs():
    tm, ref, got, _, _ = forwards("staged")
    return tm, ref, got


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact", "euler_dv"])
def test_staged_fused_matches_jax_fused_kernel(outputs, field):
    tm, ref, got = outputs
    assert not tm.plan.smooth and got.euler_dv is not None
    close(got, ref, field)
