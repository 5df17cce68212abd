"""The port's `step_n` on the G1-shaped fixture (float32, on the CPU: the
plain version of the Euler megastep kernel's extended pyramidal instance,
`hopper_mega.mega_step_n_plain`, i.e. two staged Euler steps) against the
JAX package's `step_n`, whose megastep kernel
(`pallas_constraint._megastep_batched` on the `mega_ell` plan with
pyramidal cones and a plane-mesh group) runs in interpret mode with its
gathers in float32 (`test_torch_muscle_mega.reference_mode`) and its
stacked arrays behind an optimization barrier
(`test_torch_cyl_mega.one_key_chain`).

Small fixture, 8 envs of `test_torch_g1_fixture.g1_states`, 2 substeps.
Tolerances are tests/test_megastep.py's: within rel 5e-4 of the largest
value, held on the increments of qpos and qvel over the two substeps and
on qacc_warmstart; time advanced by exactly 2 dt. Both start from the
port's converged warm start of the same state (test_torch_g1_mega.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from test_torch_cyl_mega import one_key_chain
from test_torch_g1_fixture import g1_mega_states
from test_torch_muscle_mega import reference_mode

E, N = 8, 2


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = g1_mega_states(mp, E)
            jplan = pc.get_plan(jm, jax.tree_util.tree_map(
                lambda x: x[0], jd).contact)
            assert jplan is not None and jplan.mega_ell, "the reference's"
            reference_mode(mp)
            one_key_chain(mp)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.step_n(jm, d, N)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, td, ref, fwd.step_n(tm, td, N)


@pytest.mark.parametrize("field", ["qpos", "qvel", "qacc_warmstart"])
def test_g1_step_n_matches_jax_megastep(outputs, field):
    tm, td, ref, got = outputs
    assert tm.plan.mega_ell and not tm.plan.elliptic and tm.plan.euler_dv
    assert hm.megastep_mode(tm) == (False, True)
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4


def test_g1_step_n_advances_time(outputs):
    tm, td, ref, got = outputs
    dt = float(tm.opt.timestep)
    np.testing.assert_allclose(got.time.numpy(), td.time.numpy() + N * dt,
                               rtol=1e-6)
    np.testing.assert_allclose(got.time.numpy(), ref.time, rtol=1e-6)
