"""tests/test_torch_env.py's comparisons of the port's env layer with the
JAX package's `LocoEnv`, in float64 on the CPU, on the small A1-shaped
fixture (Euler; the fall predicate of models/quadrupeds/unitree_a1.py:134-
138 on the trunk's height, list and tilt): the same trajectory, reward,
horizon, action stream and tolerances.
"""

import pytest

from test_torch_env import (run_streams, test_auto_reset_fired,  # noqa: F401
                            test_discrete_streams_match,
                            test_env_layout_matches_jax,
                            test_float_streams_match,
                            test_trajectory_matches_jax)


@pytest.fixture(scope="module")
def streams():
    return run_streams("a1")
