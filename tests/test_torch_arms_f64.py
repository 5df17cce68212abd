"""H1 and Atlas with their arms at full width (nv 25 and 31, the committed
stand-ins' generators `h1_xml(full=True, arms=True)` and
`atlas_xml(full=True, arms=True)`) in float64 on the CPU, against the JAX
package's XLA path (tests/test_torch_forward.py's `_staged`, compiled once
per model under vmap of a per-env damping model, `jm.replace(dof_damping=x)`
per env, as tests/test_torch_dr_f64.py compiles it), on 4 envs of
`biped_states` (env 0's heel discs upright on the floor, env 1's on their
rim):

- the port's staged forward (float64 data gets no plan: the port's
  collision, make_constraint and the Newton solve) with the model's own
  damping: qacc, qfrc_constraint and efc_force_contact at rel 1e-7 of their
  largest value (tests/test_torch_forward.py's tolerance);
- the damping rows at width 32 (the plan's `dyn_damping` variant, each
  env's damping from `test_torch_dr_mega.draws`): the plain versions
  `mega_forward_plain` and `fused_constraint_plain` with the rows (qacc,
  qfrc_constraint rel 1e-7); Atlas's `mega_step_n_plain` over 3 RK4
  substeps (the reference's `_rk4` over the compiled forward) and H1's
  per-substep Euler path over 3 substeps (the forward, then each env's
  implicit damping solved from qM, `forward.damping_dv`; the reference's
  `_euler`), qpos and qvel rel 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_atlas_fixture as atfx
import test_torch_h1_fixture as h1fx
from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward, hopper_fused, hopper_mega
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_affine import _canon
from test_torch_dr_mega import dr, draws, rel_err
from test_torch_forward import _staged

E, SUBSTEPS = 4, 3
FIXTURES = {"h1arms": h1fx, "atlasarms": atfx}


@pytest.fixture(scope="module", params=list(FIXTURES))
def f64(request):
    """(name, JAX model, port model, JAX data, port data, per-env damping,
    the compiled XLA forward of (data, damping))."""
    jm, tm = FIXTURES[request.param].torch_model(full=True, arms=True)
    qpos, qvel, ctrl = h1fx.biped_states(tm, E)
    dd = draws(tm, E)
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        qpos, qvel, ctrl)
    staged = jax.jit(jax.vmap(
        lambda d, x: _staged(jm.replace(dof_damping=x), d)[0]))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl))
    return request.param, jm, tm, jd, td, dd, staged


def test_arms_staged_float64_matches_xla(f64):
    """The full-width model in float64 (no plan) with its own damping
    against the XLA path."""
    name, jm, tm, jd, td, dd, staged = f64
    assert tm.nv == {"h1arms": 25, "atlasarms": 31}[name]
    own = np.broadcast_to(np.asarray(jm.dof_damping), dd.shape)
    ref = staged(jd, own)
    got = forward.forward(tm, td)
    assert int((got.efc_force_contact != 0).any(-1).sum()) > E, \
        "too few active contact slots"
    for field in ("qacc", "qfrc_constraint", "efc_force_contact"):
        assert rel_err(getattr(got, field).numpy(),
                       getattr(ref, field)) < 1e-7, field


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint"])
def test_arms_forward_plain_with_rows(f64, field):
    """The mega forward's and the fused kernel's plain versions with the
    damping rows at width 32, against the XLA path with each env's
    damping; the draws move the answer."""
    name, jm, tm, jd, td, dd, staged = f64
    assert tm.plan.nvm == 32 and dr(tm).plan.sm_dyn_damping
    ref = staged(jd, dd)
    td = td.replace(dof_damping=torch.as_tensor(dd))
    got = hopper_mega.mega_forward_plain(dr(tm), td)
    assert rel_err(getattr(got, field).numpy(), getattr(ref, field)) < 1e-7
    d = coll.collision(tm, kinematics.kinematics(tm, td))
    got = hopper_fused.fused_constraint_plain(dr(tm), d)
    assert got.euler_dv is None
    assert rel_err(getattr(got, field).numpy(), getattr(ref, field)) < 1e-7
    own = staged(jd, np.broadcast_to(np.asarray(jm.dof_damping), dd.shape))
    assert rel_err(own.qacc, ref.qacc) > 1e-4


def test_arms_substeps_with_rows(f64):
    """Atlas with its arms: the RK4 megastep's plain version with the rows
    (its megastep mode keeps the rows); H1 with its arms: Euler with
    per-env damping has no megastep, so each substep runs the forward and
    solves every env's implicit damping from qM, as the reference's
    `_euler` does after its forward."""
    name, jm, tm, jd, td, dd, staged = f64
    td = td.replace(dof_damping=torch.as_tensor(dd))
    j0 = jd  # the compiled forward's input pytree
    if name == "atlasarms":
        assert hopper_mega.megastep_mode(dr(tm)) is not None
        mp = pytest.MonkeyPatch()
        mp.setattr(jfwd, "forward", lambda m, x: staged(_canon(j0, x), dd))
        try:
            for _ in range(SUBSTEPS):
                jd = jfwd._rk4(jm, staged(_canon(j0, jd), dd))
        finally:
            mp.undo()
        got = hopper_mega.mega_step_n_plain(dr(tm), td, SUBSTEPS)
    else:
        assert hopper_mega.megastep_mode(dr(tm)) is None
        assert forward.step_n(dr(tm), td, SUBSTEPS) is None
        euler = jax.jit(jax.vmap(
            lambda d, x: jfwd._euler(jm.replace(dof_damping=x), d)))
        got = td
        for _ in range(SUBSTEPS):
            jd = euler(staged(_canon(j0, jd), dd), dd)
            got = forward.step(dr(tm), got)
    assert rel_err(got.qpos.numpy(), jd.qpos) < 1e-6
    assert rel_err(got.qvel.numpy(), jd.qvel) < 1e-6
