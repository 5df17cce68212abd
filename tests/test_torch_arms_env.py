"""tests/test_torch_env.py's comparisons of the port's env layer with the
JAX package's `LocoEnv`, in float64 on the CPU, on the small variant of H1
with its arms (`test_torch_h1_fixture.h1_xml(arms=True)`: nv 25, past the
kernels' first compiled width; Euler, the plane-cylinder and plane-mesh
groups; H1's own fall predicate, models/humanoids/unitree_h1.py:44-54, on
the pelvis's ty, tilt, list and rotation): the same trajectory, reward,
horizon, action stream and tolerances (float values rel 1e-6 of their
largest, booleans exact, over 3 control steps of 4 envs with the
auto-reset firing at the second), without damping randomization.
"""

import pytest

from test_torch_env import (run_streams, test_auto_reset_fired,  # noqa: F401
                            test_discrete_streams_match,
                            test_env_layout_matches_jax,
                            test_float_streams_match,
                            test_trajectory_matches_jax)


@pytest.fixture(scope="module")
def streams():
    return run_streams("h1arms")
