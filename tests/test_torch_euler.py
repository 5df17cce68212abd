"""The port's Euler megastep against the JAX package's, on the small
fixture's Euler configuration (`test_torch_fixture.CONFIGS["euler"]`).

The port's `step_n` in float32 on the CPU (`hopper_mega.mega_step_n_plain`,
the megastep kernel's plain version: two staged Euler steps, the implicit
damping (M + dt diag(damping))^-1 M qacc solved from each forward's qM as
the kernel solves it from its M) against the JAX package's `step_n`, whose
megastep kernel (`pallas_constraint._megastep_batched`, Euler branch with
`euler_dv`) runs in interpret mode: 8 envs in light contact, 2 substeps,
the increments of qpos and qvel and the carried warm start within rel 5e-4
of the largest value (tests/test_torch_megastep.py's limits), time advanced
by 2 dt. The float64 Euler step against the XLA path is in
tests/test_torch_forward.py.
"""

import jax
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.ops import forward
from test_torch_fixture import CONFIGS, mega_states

EULER = CONFIGS["euler"]


@pytest.fixture(scope="module")
def megastep():
    E, n = 8, 2
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = mega_states(mp, full=False, n_envs=E,
                                         change=EULER)
            mp.setattr(pn, "_INTERPRET", True)
            mp.setattr(pn, "pallas_enabled", lambda: True)
            ref = jax.jit(jax.vmap(lambda d: jfwd.step_n(jm, d, n)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, td, ref, forward.step_n(tm, td, n), n


@pytest.mark.parametrize("field", ["qpos", "qvel", "qacc_warmstart"])
def test_euler_step_n_matches_jax_megastep(megastep, field):
    tm, td, ref, got, n = megastep
    assert tm.plan.mega and tm.plan.euler_dv
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4
    np.testing.assert_allclose(got.time.numpy(),
                               td.time.numpy() + n * float(tm.opt.timestep),
                               rtol=1e-6)
