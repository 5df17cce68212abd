"""The port's collision on the A1-shaped fixture against the JAX package's
XLA collision, in float64 on the CPU.

Full-width fixture (`test_torch_a1_fixture`), 64 seeded states: the feet
pressed into the floor, a quarter of the envs tipped over so that legs,
hips, trunk and the self pairs touch. For every contact group (one per
classic analytic pair kind, the parameter), over all its slots: geom ids
exact (the midphase's ranking and its first-index ties), the slot's
statics equal, and depth, position and frame within 1e-12 (the two sides
round the same formulas in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_a1_fixture import CENSUS_FULL, a1_states, torch_model

E = 64


@pytest.fixture(scope="module")
def contacts():
    jm, tm = torch_model(full=True)
    qpos, qvel, _ = a1_states(tm, E)
    d0 = jax_make_data(jm)
    ref = jax.jit(jax.vmap(lambda q: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q)))))(jnp.asarray(qpos))
    ref = jax.tree_util.tree_map(np.asarray, ref.contact)
    td = tio.make_data(tm, E).replace(qpos=torch.as_tensor(qpos),
                                      qvel=torch.as_tensor(qvel))
    got = coll.collision(tm, kinematics.kinematics(tm, td)).contact
    return tm, ref, got


@pytest.mark.parametrize("group", range(len(CENSUS_FULL)),
                         ids=[f"{t1}-{t2}" for t1, t2, *_ in CENSUS_FULL])
def test_group_matches_jax_collision(contacts, group):
    tm, ref, got = contacts
    g = tm.groups[group]
    assert (g.t1, g.t2, g.condim, g.k) == CENSUS_FULL[group][:4]
    sl = slice(g.offset, g.offset + g.k * g.slots)
    for name in ("geom1", "geom2"):
        np.testing.assert_array_equal(getattr(got, name)[:, sl].numpy(),
                                      getattr(ref, name)[:, sl], err_msg=name)
    for name in ("includemargin", "friction", "solref", "solimp"):
        np.testing.assert_array_equal(getattr(got, name)[:, sl].numpy(),
                                      getattr(ref, name)[:, sl], err_msg=name)
    np.testing.assert_array_equal(got.dim[sl], ref.dim[sl])
    for name in ("dist", "pos", "frame"):
        np.testing.assert_allclose(getattr(got, name)[:, sl].numpy(),
                                   getattr(ref, name)[:, sl], rtol=0,
                                   atol=1e-12, err_msg=name)
    # the group is exercised: some of its slots are in contact
    active = ref.dist[:, sl] < ref.includemargin[:, sl]
    assert active.any()


def test_rbound_matches_jax(contacts):
    """The self groups' static bounding radii (`_rbound`)."""
    tm, _, _ = contacts
    jm = torch_model(full=False)[0]
    rb = jcoll._rbound(jm, None)
    _, small = torch_model(full=False)
    np.testing.assert_allclose(coll.rbound(small).numpy(), np.asarray(rb),
                               rtol=0, atol=1e-15)


def test_convex_tail_inactive_in_float32():
    """A convex pair (two hulls of the torque fixture) loads in float32:
    its group sorts after the classic ones, its slots stay inactive with
    the first candidates' ids (the reference's float32 path, collision.py
    :870), and the row plan sizes to the classic prefix (`classic_ncon`)."""
    from test_torch_fixture import ASSET as TORQUE

    leaves, aux = tio.read_model_npz(TORQUE)
    aux["pair_geom1"] = aux["pair_geom1"].copy()
    aux["pair_geom1"][-1] = 76
    m = tio.model_from_numpy(leaves, aux, device="cpu")
    g = m.groups[-1]
    assert g.convex and (g.t1, g.t2, g.k, g.slots) == (7, 7, 1, 1)
    assert coll.classic_ncon(m.groups, m.ncon) == g.offset == m.ncon - 1
    assert m.plan is not None and m.plan.ncon == g.offset
    d = coll.collision(m, kinematics.kinematics(m, tio.make_data(m, 2)))
    assert bool((d.contact.dist[:, -1] == coll.BIG).all())
    assert d.contact.geom1[:, -1].tolist() == [76, 76]
    with pytest.raises(NotImplementedError, match="convex"):
        tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float64)
