"""The fused kernel's smooth stage with affine gain and bias:
`hopper_fused.fused_constraint_plain` (float32, on the CPU: the fused
kernel's plain version) against the reference's
`pallas_constraint.fused_constraint`, whose kernel (`_fused_batched`, its
smooth branch computing the affine terms in `_smooth_preamble`,
`:1126-1147`) runs in interpret mode with its gathers in float32
(`test_torch_muscle_mega.reference_mode`).

Two models, 8 envs each in light contact, both versions from the same FK
outputs, contacts and warm start (the port's converged solve, as a stepped
env is; test_torch_fused.py):

* `a1pos`: the small A1 position variant (the elliptic layout, the
  29-float pack; `test_torch_a1_fixture.ell_states`): qacc and euler_dv
  within rel 5e-4 of the largest value, qfrc_constraint and the
  per-contact forces within the reference's own 2e-3 for the fused
  elliptic path's forces (tests/test_pallas_newton.py);
* `humanoid`: the small torque humanoid with affine motors, Euler (the
  smooth layout, the 5-float pack; `test_torch_fixture.mega_states`):
  every field within rel 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_a1_fixture import ell_states
from test_torch_fixture import CONFIGS, mega_states
from test_torch_muscle_mega import reference_mode

E = 8
MODELS = ("a1pos", "humanoid")


@pytest.fixture(scope="module")
def outputs():
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in MODELS:
            with jax.enable_x64(False):
                if name == "a1pos":
                    jm, tm, jd, td = ell_states(E, mode="position")
                else:
                    jm, tm, jd, td = mega_states(
                        mp, full=False, n_envs=E, change=CONFIGS["euler"],
                        affine=True)
                mp.setattr(pc, "_PLAN_CACHE", {})
                reference_mode(mp)
                d = coll.collision(tm, kinematics.kinematics(tm, td))
                ws = hf.fused_constraint_plain(tm, d).qacc
                d = d.replace(qacc_warmstart=ws)
                jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
                plan = pc.get_plan(jm, jax.tree_util.tree_map(
                    lambda x: x[0], jd).contact)
                assert plan.smooth and plan.pack_w == tm.plan.pack_w
                ref = jax.jit(jax.vmap(
                    lambda d, jm=jm, plan=plan: pc.fused_constraint(
                        jm, d, plan)))(jd)
                out[name] = (tm, d, jax.tree_util.tree_map(np.asarray, ref),
                             hf.fused_constraint_plain(tm, d))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("field", ["qacc", "euler_dv", "qfrc_constraint",
                                   "efc_force_contact"])
@pytest.mark.parametrize("name", MODELS)
def test_fused_plain_matches_jax_fused_kernel(outputs, name, field):
    tm, d, ref, got = outputs[name]
    assert tm.plan.smooth and tm.plan.euler_dv
    assert all(a["b_affine"] for a in tm.plan.sm_acts)
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        active = d.contact.dist < d.contact.includemargin
        assert int(active.sum()) > E, "too few active contact slots"
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    tol = 2e-3 if tm.plan.elliptic and field in (
        "qfrc_constraint", "efc_force_contact") else 5e-4
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < tol
