"""The megastep with affine gain and bias in its smooth stage: the port's
`step_n` on the small A1 position variant (float32, on the CPU: the plain
version of the Euler megastep kernel with the extended collision,
`hopper_mega.mega_step_n_plain`, i.e. two staged Euler steps) against the
JAX package's `step_n`, whose megastep kernel
(`pallas_constraint._megastep_batched` on the `mega_ell` plan, its smooth
stage with the servos' affine bias) runs in interpret mode with its
gathers in float32 (`test_torch_muscle_mega.reference_mode`).

8 envs in light contact (`test_torch_a1_fixture.ell_states`, targets in the
joint ranges), 2 substeps. Tolerances are tests/test_megastep.py's: within
rel 5e-4 of the largest value, held on the increments of qpos and qvel over
the two substeps and on qacc_warmstart; time advanced by exactly 2 dt.
Both start from the port's converged warm start of the same state
(test_torch_ell_megastep.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_a1_fixture import ell_states
from test_torch_muscle_mega import reference_mode

E, N = 8, 2


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = ell_states(E, mode="position")
            mp.setattr(pc, "_PLAN_CACHE", {})
            reference_mode(mp)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.step_n(jm, d, N)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, td, ref, fwd.step_n(tm, td, N)


@pytest.mark.parametrize("field", ["qpos", "qvel", "qacc_warmstart"])
def test_a1pos_step_n_matches_jax_megastep(outputs, field):
    tm, td, ref, got = outputs
    assert tm.plan.mega_ell and tm.plan.euler_dv
    assert all(a["b_affine"] for a in tm.plan.sm_acts)
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4


def test_a1pos_step_n_advances_time(outputs):
    tm, td, ref, got = outputs
    dt = float(tm.opt.timestep)
    np.testing.assert_allclose(got.time.numpy(), td.time.numpy() + N * dt,
                               rtol=1e-6)
    np.testing.assert_allclose(got.time.numpy(), ref.time, rtol=1e-6)
