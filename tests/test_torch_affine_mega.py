"""The mega forward with affine gain and bias in its smooth stage: the
port's forward (float32, on the CPU: `hopper_mega.mega_forward_plain`, the
plain version of the mega forward kernel) against the JAX package's mega
forward (`pallas_constraint._mega_batched`, whose `_smooth_preamble`
computes the affine terms, `:1126-1147`), run in interpret mode as
tests/test_mega.py runs it, with its gathers in float32
(`test_torch_muscle_mega.reference_mode`).

Two models, 8 envs each in light contact:

* `a1pos`: the small A1 position variant (`test_torch_a1_fixture`, two
  legs, budgets 2 / 1; position servos, fixed gain and affine bias, targets
  in the joint ranges) on the extended collision with elliptic rows
  (`mega_ell`; `ell_states`);
* `humanoid`: the small torque humanoid with affine motors (gain and bias,
  all six prms nonzero; `test_torch_fixture.AFFINE_MOTOR`), RK4, on the
  plane-only collision (`mega_states`).

Tolerances are tests/test_mega.py's: qacc, qfrc_constraint and
efc_force_contact within rel 5e-4 of the largest value; active slots
equal, geom1 and geom2 exact on active slots, depths atol 1e-5. Both
forwards warm-start from the port's own forward of the same state, as a
stepped env is (test_torch_mega.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_a1_fixture import ell_states
from test_torch_fixture import mega_states
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
                    jm, tm, jd, td = mega_states(mp, full=False, n_envs=E,
                                                 affine=True)
                mp.setattr(pc, "_PLAN_CACHE", {})
                reference_mode(mp)
                ws = fwd.forward(tm, td).qacc
                td = td.replace(qacc_warmstart=ws)
                jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
                ref = jax.jit(jax.vmap(
                    lambda d, jm=jm: jfwd.forward(jm, d)))(jd)
                out[name] = (tm, jax.tree_util.tree_map(np.asarray, ref),
                             fwd.forward(tm, td))
    finally:
        mp.undo()
    return out


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("name", MODELS)
def test_affine_model_takes_the_mega_path(outputs, name):
    """The plan carries the affine terms (`sm_acts`) and takes the mega
    path: the extended elliptic instance for A1, the plane-only one for
    the humanoid."""
    tm, ref, got = outputs[name]
    plan = tm.plan
    assert plan.mega and plan.smooth
    assert plan.mega_ell == plan.elliptic == (name == "a1pos")
    assert all(a["b_affine"] for a in plan.sm_acts)
    assert all(a["g_affine"] != (name == "a1pos") for a in plan.sm_acts)
    active = got.contact.dist < got.contact.includemargin
    assert int(active.sum()) > E, "too few active contact slots"


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
@pytest.mark.parametrize("name", MODELS)
def test_mega_forward_matches_jax_mega_kernel(outputs, name, field):
    tm, ref, got = outputs[name]
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4


@pytest.mark.parametrize("name", MODELS)
def test_mega_contacts_match_jax_mega_kernel(outputs, name):
    tm, ref, got = outputs[name]
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    for field in ("geom1", "geom2"):
        np.testing.assert_array_equal(
            getattr(got.contact, field).numpy()[active],
            getattr(ref.contact, field)[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5
