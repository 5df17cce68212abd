"""The port's `step_n` (float32, on the CPU: the plain version of the
megastep kernel, `hopper_mega.mega_step_n_plain`, i.e. two staged RK4
steps) against the JAX package's `step_n`, whose megastep kernel
(`pallas_constraint._megastep_batched`) runs in interpret mode as
tests/test_mega.py runs it.

Small fixture, 8 envs seeded with numpy in light contact
(`test_torch_fixture.mega_states`), 2 substeps. Tolerances are
tests/test_mega.py's: within rel 5e-4 of the largest value, held on the
increments of qpos and qvel over the two substeps (2 ms move qpos by
about 1% of its largest value, so rel 5e-4 of the values themselves would
let a twentieth of the step go unchecked) and on qacc_warmstart; time
advanced by exactly 2 dt.
"""

import jax
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_fixture import mega_states

E, N = 8, 2


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = mega_states(mp, full=False, n_envs=E)
            mp.setattr(pn, "_INTERPRET", True)
            mp.setattr(pn, "pallas_enabled", lambda: True)
            ref = jax.jit(jax.vmap(lambda d: jfwd.step_n(jm, d, N)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, td, ref, fwd.step_n(tm, td, N)


@pytest.mark.parametrize("field", ["qpos", "qvel", "qacc_warmstart"])
def test_step_n_matches_jax_megastep(outputs, field):
    tm, td, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4


def test_step_n_advances_time(outputs):
    tm, td, ref, got = outputs
    dt = float(tm.opt.timestep)
    np.testing.assert_allclose(got.time.numpy(), td.time.numpy() + N * dt,
                               rtol=1e-6)
    np.testing.assert_allclose(got.time.numpy(), ref.time, rtol=1e-6)
    # the carried warm start is what step_n returns as qacc
    np.testing.assert_array_equal(got.qacc.numpy(),
                                  got.qacc_warmstart.numpy())


def test_step_n_switches(outputs, monkeypatch):
    """LMT_MEGASTEP=0 or LMT_MEGA=0 turn step_n off (None: the caller runs
    `step` n times), as in the reference."""
    tm, td, ref, got = outputs
    for var in ("LMT_MEGASTEP", "LMT_MEGA"):
        monkeypatch.setenv(var, "0")
        assert fwd.step_n(tm, td, N) is None
        monkeypatch.delenv(var)
