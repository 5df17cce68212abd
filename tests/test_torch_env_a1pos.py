"""tests/test_torch_env.py's comparisons of the port's env layer with the
JAX package's `LocoEnv`, in float64 on the CPU, on the small A1 position
variant (`test_torch_a1_fixture.a1_xml(mode="position")`: position servos,
fixed gain kp and affine bias (0, -kp, -kv), the ctrlrange each joint's
range; Euler; A1's fall predicate, which `standins.env_parts` picks by the
stand-in's kind): both envs unnormalize the actions into the ctrlrange, so
the actions are joint-angle targets; the same trajectory, reward, horizon,
action stream and tolerances (float values rel 1e-6 of their largest,
booleans exact, over 3 control steps of 4 envs with the auto-reset firing
at the second).
"""

import pytest

from test_torch_env import (run_streams, test_auto_reset_fired,  # noqa: F401
                            test_discrete_streams_match,
                            test_env_layout_matches_jax,
                            test_float_streams_match,
                            test_trajectory_matches_jax)


@pytest.fixture(scope="module")
def streams():
    jenv, tenv, out = run_streams("a1pos")
    m = tenv.model
    assert all(b == 1 for b in m.actuator_biastype)  # the servos' bias
    jnt = m.actuator_trnid[:, 0]
    assert bool((m.actuator_ctrlrange == m.jnt_range[jnt]).all())
    return jenv, tenv, out
