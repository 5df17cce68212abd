"""The port's forward on the A1-shaped fixture's mega path (float32, on the
CPU: `hopper_mega.mega_forward_plain`, the plain version of the mega
forward kernel with the extended collision) against the JAX package's
`mega_ell` forward (`pallas_constraint._mega_batched` with
`pallas_fk.collide_env_block_ext` and `_mega_ell_finish`), run in interpret
mode as tests/test_mega.py runs it, with its gathers in float32
(`test_torch_muscle_mega.reference_mode`).

Small fixture, 8 envs in light contact (`test_torch_a1_fixture.ell_states`:
standing, legs touching each other, tipped over). Tolerances are
tests/test_mega.py's: qacc, qfrc_constraint and efc_force_contact within
rel 5e-4 of the largest value; active slots equal, geom1 and geom2 equal on
active slots (self pairs: geom1 comes from the kernel), depths atol 1e-5;
the per-slot includemargin and friction the groups' statics. Both forwards
warm-start from the port's own forward of the same state, as a stepped env
is (test_torch_mega.py).
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

E = 8


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = ell_states(E)
            mp.setattr(pc, "_PLAN_CACHE", {})
            reference_mode(mp)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, ref, fwd.forward(tm, td)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_mega_forward_takes_the_ext_path(outputs):
    tm, ref, got = outputs
    assert tm.plan.mega and tm.plan.mega_ell and tm.plan.elliptic
    active = got.contact.dist < got.contact.includemargin
    assert int(active.sum()) > E, "too few active contact slots"
    # self pairs in contact: geom1 is no plane there
    assert bool((active & (got.contact.geom1 != 0)).any())


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_mega_forward_matches_jax_mega_ell(outputs, field):
    tm, ref, got = outputs
    assert rel_err(getattr(got, field).numpy(), getattr(ref, field)) < 5e-4


def test_mega_ell_contacts_match_jax(outputs):
    tm, ref, got = outputs
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    for name in ("geom1", "geom2"):
        np.testing.assert_array_equal(getattr(got.contact, name).numpy()[active],
                                      getattr(ref.contact, name)[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5
    for name in ("includemargin", "friction"):
        np.testing.assert_allclose(getattr(got.contact, name).numpy(),
                                   getattr(ref.contact, name), rtol=1e-6)
