"""tests/test_torch_env.py's comparisons of the port's env layer with the
JAX package's `LocoEnv`, in float64 on the CPU, on the small variant of G1
with its arms (`test_torch_g1_fixture.g1_xml(arms=True)`: nv 25, past the
kernels' first compiled width; Euler, the extended collision's groups;
G1's own fall predicate, models/humanoids/unitree_g1.py:43-54): the same
trajectory, reward, horizon, action stream and tolerances (float values
rel 1e-6 of their largest, booleans exact, over 3 control steps of 4 envs
with the auto-reset firing at the second), without damping
randomization.
"""

import pytest

from test_torch_env import (run_streams, test_auto_reset_fired,  # noqa: F401
                            test_discrete_streams_match,
                            test_env_layout_matches_jax,
                            test_float_streams_match,
                            test_trajectory_matches_jax)


@pytest.fixture(scope="module")
def streams():
    return run_streams("g1arms")
