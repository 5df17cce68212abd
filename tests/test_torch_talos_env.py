"""tests/test_torch_env.py's comparisons of the port's env layer with the
JAX package's `LocoEnv`, in float64 on the CPU, on the small Talos-shaped
fixture (Euler; a plane-box group and a plane-mesh group at k = P, which
the staged path keeps in pair order; Talos's own fall predicate,
models/humanoids/talos.py:47-66, on the pelvis's ty, tilt, list and
rotation and the back's bky and bkz, which `standins.env_parts` picks by
the stand-in's kind): the same trajectory, reward, horizon, action stream
and tolerances (float values rel 1e-6 of their largest, booleans exact,
over 3 control steps of 4 envs with the auto-reset firing at the second).
"""

import pytest

from test_torch_env import (run_streams, test_auto_reset_fired,  # noqa: F401
                            test_discrete_streams_match,
                            test_env_layout_matches_jax,
                            test_float_streams_match,
                            test_trajectory_matches_jax)


@pytest.fixture(scope="module")
def streams():
    return run_streams("talos")
