"""The plane-mesh kernel's per-variant hull tables
(`hopper_collision.stack_plans`, `mesh_slots(..., env_id=)`) on the CPU.

* `mesh_slots_plain` with K = 2 (the small torque fixture at the 4-ages
  scalings 0.6 and 1.0, float32, the mesh group at k 4 < P 10), each env's
  poses from the port's kinematics of its per-env Model, against the JAX
  package's collision of `_model_at(env_id)` per env (vmapped, jitted
  once; its traced hull vertices keep the reference on its XLA plane-mesh
  path), at tests/test_torch_mesh_slots.py's rule: active masks and geom
  ids exact, dist atol 1e-6, pos atol 1e-5, frame atol 1e-6 on active
  slots; both variants have active slots, and an env's slots differ from
  what the other variant's table gives at the same poses.
* K = 1: a stack of equal tables keeps the plan (the same object), and a
  stack's first variant's tables are the single model's, bit for bit, as
  is `mesh_slots_plain` with every env on variant 0.
* The kernel's checks: a plan of K > 1 tables raises without each env's
  variant (wrapper and plain version alike), and plans whose hull
  layouts differ do not stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import hopper_collision as hc
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_collision import poses
from test_torch_fixture import export_model, jax_model

E = 8
GROUP = 1  # the fixture's plane-mesh group
SCALINGS = (0.6, 1.0)
ENV_IDS = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.int32)
DROPS = (0.004, 0.02)


@pytest.fixture(scope="module")
def f32_variants():
    """[(JAX float32 model, port float32 model)] at SCALINGS, the port's
    stack and the JAX stack of their leaves."""
    pairs = []
    with jax.enable_x64(False):
        for s in SCALINGS:
            jm = jax_model(full=False, dtype=jnp.float32, scaling=s)
            leaves, aux = export_model(jm)
            pairs.append((jm, tio.model_from_numpy(
                leaves, aux, device="cpu", dtype=torch.float32)))
        # the JAX env's stack (envs/base.py:117-135): the base's budget
        # and stat_meaninertia in every variant
        base = pairs[0][0]
        norm = [jm.replace(opt=jm.opt.replace(
            iterations=base.opt.iterations,
            ls_iterations=base.opt.ls_iterations),
            stat_meaninertia=base.stat_meaninertia) for jm, _ in pairs]
        jstack = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *norm)
    stacked, _ = tio.stack_variants([tm for _, tm in pairs])
    return pairs, stacked, jstack


@pytest.fixture(scope="module")
def jax_contacts(f32_variants):
    """The reference's collision of each env's variant, jitted once."""
    pairs, _, jstack = f32_variants
    with jax.enable_x64(False):
        d0 = jax_make_data(pairs[0][0])

        def one(i, q):
            jm = jax.tree_util.tree_map(lambda x: x[i], jstack)
            return jcoll.collision(jm, jkin.kinematics(
                jm, d0.replace(qpos=q))).contact

        fn = jax.jit(jax.vmap(one))
    return lambda q: fn(jnp.asarray(ENV_IDS), jnp.asarray(q, jnp.float32))


def _per_env_poses(stacked, qpos):
    m = tio.model_at(stacked, torch.as_tensor(ENV_IDS))
    d = tio.make_data(m, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32))
    return kinematics.kinematics(m, d)


@pytest.mark.parametrize("drop", DROPS)
def test_k2_tables_match_jax_per_env(f32_variants, jax_contacts, drop):
    pairs, stacked, _ = f32_variants
    tm0 = pairs[0][1]
    g, plan = stacked.groups[GROUP], stacked.mesh_kernel[GROUP]
    assert plan.K == 2 and plan.k < plan.P
    qpos = poses(tm0, drop)
    with jax.enable_x64(False):
        ref = jax_contacts(qpos)
    d = _per_env_poses(stacked, qpos)
    ids = torch.as_tensor(ENV_IDS)
    got = hc.mesh_slots_plain(plan, d.geom_xpos, d.geom_xmat, env_id=ids)
    n = g.k * g.slots
    sl = slice(g.offset, g.offset + n)
    r_act = np.asarray(ref.dist)[:, sl] < np.asarray(ref.includemargin)[:, sl]
    g_act = (got[0] < got[8][..., None]).reshape(E, n).numpy()
    np.testing.assert_array_equal(g_act, r_act)
    for v in range(2):
        assert r_act[ENV_IDS == v].any(), f"variant {v}: no active slot"
    slot = g_act.reshape(E, g.k, 3)[..., 0]
    for i, name in ((3, "geom1"), (4, "geom2")):
        np.testing.assert_array_equal(
            got[i].numpy()[slot],
            np.asarray(getattr(ref, name))[:, sl].reshape(E, g.k, 3)[..., 0]
            [slot])
    for i, name, atol, tail in ((0, "dist", 1e-6, ()), (1, "pos", 1e-5, (3,)),
                                (2, "frame", 1e-6, (3, 3))):
        r = np.asarray(getattr(ref, name))[:, sl].reshape(E, g.k, 3, *tail)
        gv = got[i].numpy()
        if name == "frame":  # one per pair: the rank's first slot's
            np.testing.assert_allclose(gv[slot], r[:, :, 0][slot], rtol=0,
                                       atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(gv.reshape(E, n, *tail)[g_act],
                                       r.reshape(E, n, *tail)[r_act],
                                       rtol=0, atol=atol, err_msg=name)
    for i, name in ((5, "friction"), (6, "solref"), (7, "solimp")):
        np.testing.assert_array_equal(
            got[i].numpy()[slot],
            np.asarray(getattr(ref, name))[:, sl].reshape(
                E, g.k, 3, -1)[:, :, 0][slot])
    # the tables matter: every env on the other variant's gives other
    # depths at these poses
    other = hc.mesh_slots_plain(plan, d.geom_xpos, d.geom_xmat,
                                env_id=1 - ids)
    assert not torch.equal(other[0], got[0])


def test_k1_tables_bit_for_bit(f32_variants):
    pairs, stacked, _ = f32_variants
    p0, p1 = (tm.mesh_kernel[GROUP] for _, tm in pairs)
    assert hc.stack_plans([p0, dataclasses.replace(p0, _dev={})]) is p0
    st = stacked.mesh_kernel[GROUP]
    n = p0.flat.size
    assert st.table_floats == n == p1.flat.size
    np.testing.assert_array_equal(st.flat[:n], p0.flat)
    np.testing.assert_array_equal(st.flat[n:], p1.flat)
    for name in ("pair_f", "tbl16", "verts"):
        a = getattr(st, name)
        np.testing.assert_array_equal(a[:p0.P], getattr(p0, name))
        np.testing.assert_array_equal(a[p0.P:], getattr(p1, name))
    for name in ("pid", "pg1", "pg2", "pair_i", "vmask", "nbr"):
        np.testing.assert_array_equal(getattr(st, name), getattr(p0, name))
    # every env on variant 0: the single model's plain version, bit for bit
    d = _per_env_poses(stacked, poses(pairs[0][1], 0.02))
    zero = torch.zeros(E, dtype=torch.int32)
    got = hc.mesh_slots_plain(st, d.geom_xpos, d.geom_xmat, env_id=zero)
    ref = hc.mesh_slots_plain(p0, d.geom_xpos, d.geom_xmat)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_variant_tables_checked(f32_variants):
    pairs, stacked, _ = f32_variants
    st = stacked.mesh_kernel[GROUP]
    d = _per_env_poses(stacked, poses(pairs[0][1], 0.02))
    with pytest.raises(ValueError, match="env_id"):
        hc.mesh_slots_plain(st, d.geom_xpos, d.geom_xmat)
    with pytest.raises(ValueError, match="variant"):
        hc.check(st, d.geom_xpos, d.geom_xmat)
    p0 = pairs[0][1].mesh_kernel[GROUP]
    bad = dataclasses.replace(p0, k=p0.k - 1, _dev={})
    with pytest.raises(ValueError, match="hull layout"):
        hc.stack_plans([p0, bad])
