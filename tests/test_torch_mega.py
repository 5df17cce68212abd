"""The port's forward on the mega path (float32, on the CPU: the plain
version of the mega kernel, `hopper_mega.mega_forward_plain`) against the
JAX package's mega kernel (`pallas_constraint._mega_batched`), run in
interpret mode as tests/test_mega.py runs it.

Small fixture, 8 envs seeded with numpy in light contact
(`test_torch_fixture.mega_states`). Tolerances are tests/test_mega.py's:
qacc, qfrc_constraint and efc_force_contact within rel 5e-4 of the largest
value; contact depths atol 1e-5 and geom2 exact on active slots. Both
forwards warm-start from the port's own forward of the same state, as a
stepped env is warm-started from its last step (test_torch_fused.py): from
a cold start, float32 summation orders stop some envs one Newton step apart
(the termination test compares an improvement with a floor below the
costs' rounding), and the reference's kernel does not return its decisions
for a replay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_fixture import mega_states

E = 8


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = mega_states(mp, full=False, n_envs=E)
            mp.setattr(pn, "_INTERPRET", True)
            mp.setattr(pn, "pallas_enabled", lambda: True)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    got = fwd.forward(tm, td)
    return tm, ref, got


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_mega_forward_takes_the_mega_path(outputs):
    tm, ref, got = outputs
    assert tm.plan is not None and tm.plan.mega
    active = got.contact.dist < got.contact.includemargin
    assert int(active.sum()) > 2 * E, "too few active contact slots"
    # the mega contract: the plane as geom1, the static margin and friction
    assert bool((got.contact.geom1 == tm.plan.plane_gid).all())
    np.testing.assert_array_equal(got.contact.includemargin.numpy(),
                                  np.float32(tm.plan.c_margin))


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_mega_forward_matches_jax_mega_kernel(outputs, field):
    tm, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4


def test_mega_contacts_match_jax_mega_kernel(outputs):
    tm, ref, got = outputs
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    np.testing.assert_array_equal(got.contact.geom2.numpy()[active],
                                  ref.contact.geom2[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5
