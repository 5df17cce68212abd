"""The port's Euler megastep on the muscle humanoid against the JAX
package's, on the small muscle fixture.

The port's `step_n` in float32 on the CPU (`hopper_mega.mega_step_n_plain`,
the megastep kernel's plain version: two staged Euler steps of the
non-smooth stages, the fused stage, the implicit damping and act += dt
act_dot clamped to actrange) against the JAX package's `step_n`, whose
megastep kernel (`pallas_constraint._megastep_batched`, Euler branch
carrying act, the muscle block inlined) runs in interpret mode as
`test_torch_muscle_mega.reference_mode` runs it: 8 envs in light contact
(`test_torch_fixture.mega_states(muscle=True)`; every fourth activation
starts above 1 at full control, so the first substep clamps it), 2
substeps. The increments of qpos, qvel and act and the carried warm start
within rel 5e-4 of the largest value (tests/test_torch_euler.py's limits).
"""

import jax
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu_torch.ops import forward
from test_torch_fixture import mega_states
from test_torch_muscle_mega import reference_mode

N = 2


@pytest.fixture(scope="module")
def megastep():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = mega_states(mp, full=False, n_envs=8,
                                         muscle=True)
            reference_mode(mp)
            ref = jax.jit(jax.vmap(lambda d: jfwd.step_n(jm, d, N)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, td, ref, forward.step_n(tm, td, N)


@pytest.mark.parametrize("field", ["qpos", "qvel", "act", "qacc_warmstart"])
def test_muscle_step_n_matches_jax_megastep(megastep, field):
    tm, td, ref, got = megastep
    assert tm.plan.mega and tm.plan.mp is not None and got is not None
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4
    if field == "act":
        assert bool(((got.act >= 0) & (got.act <= 1)).all())
        assert bool((td.act > 1).any())
    np.testing.assert_allclose(got.time.numpy(),
                               td.time.numpy() + N * float(tm.opt.timestep),
                               rtol=1e-6)
