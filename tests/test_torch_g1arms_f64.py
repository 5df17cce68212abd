"""G1 with its arms at full width (nv 29, the committed stand-in's
generator, `test_torch_g1_fixture.g1_xml(full=True, arms=True)`) in
float64 on the CPU: the port's staged forward (float64 data gets no plan:
the port's collision, make_constraint and the Newton solve) against the
JAX package's XLA path (tests/test_torch_forward.py's `_staged`), qacc,
qfrc_constraint and efc_force_contact at rel 1e-7 of their largest value
(tests/test_torch_forward.py's tolerance), on 4 envs of `g1_states`
(standing, and each self group in contact in envs 1-3).
"""

import jax
import numpy as np
import torch

import test_torch_g1_fixture as g1_fix
from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_forward import _staged


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_g1arms_staged_float64_matches_xla():
    """The full-width model (nv 29) in float64 (no plan: the port's
    collision, make_constraint and the Newton solve) against the XLA
    path."""
    jm, tm = g1_fix.torch_model(full=True, arms=True)
    assert tm.nv == 29
    qpos, qvel, ctrl = g1_fix.g1_states(tm, 4)
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        qpos, qvel, ctrl)
    ref, (_, _, _, _, active) = jax.jit(jax.vmap(lambda d: _staged(jm, d)))(
        jd)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    got = fwd.forward(tm, tio.make_data(tm, 4).replace(
        qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl)))
    assert np.asarray(active).sum() > 8, "too few active rows"
    for field in ("qacc", "qfrc_constraint", "efc_force_contact"):
        assert rel_err(getattr(got, field).numpy(),
                       getattr(ref, field)) < 1e-7, field
