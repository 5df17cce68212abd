"""The port's collision against the JAX package, on the small fixture.

* float64: the port's XLA-path collision (plane-box and the plane-mesh XLA
  narrowphase) against `loco_mujoco_tpu.ops.collision` (XLA), atol 1e-9.
* float32: the plain version of the port's plane-mesh kernel
  (`hopper_collision.mesh_slots_plain`, reached through the kernel path on
  CPU tensors; its manifold, `manifold_plain`, bucket by bucket) against
  the JAX package's Pallas kernels run in interpret mode, as
  tests/test_pallas_collision.py runs them: active masks and geom ids
  exact, dist atol 1e-6, pos atol 1e-5, frame atol 1e-6 on active slots
  (on inactive ones the Pallas kernels write their conservative bound, the
  plain version the exact depth).
* the relayouts against `pallas_layout`: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import pallas_collision as jpc
from loco_mujoco_tpu.ops import pallas_layout as jlay
from loco_mujoco_tpu.ops import pallas_newton as jpn
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import collision, kinematics
from loco_mujoco_tpu_torch.ops import hopper_collision as hc
from loco_mujoco_tpu_torch.ops import hopper_layout as lay
from test_torch_fixture import export_model, jax_model, torch_model

E = 8
DROPS = [0.004, 0.02, 0.05]


def poses(model, drop, seed=3):
    """qpos0 + seeded noise, with the root lowered by `drop` (m) so that
    feet and foot hulls reach the floor."""
    rng = np.random.default_rng(seed)
    qpos = np.asarray(model.qpos0)[None] + rng.normal(scale=0.05,
                                                      size=(E, model.nq))
    qpos[:, int(model.jnt_qposadr[model.names["joint"]["root_z"]])] -= drop
    return qpos


def jax_contacts(jm, qpos):
    d0 = jax_make_data(jm)

    def one(q):
        return jcoll.collision(jm, jkin.kinematics(jm, d0.replace(qpos=q)))

    return jax.jit(jax.vmap(one))(qpos).contact


def torch_contacts(tm, qpos):
    d = tio.make_data(tm, E).replace(
        qpos=torch.as_tensor(qpos, dtype=tm.qpos0.dtype))
    return collision.collision(tm, kinematics.kinematics(tm, d)).contact


def assert_active_match(ref, got, atol_d, atol_p, atol_f):
    r_act = np.asarray(ref.dist) < np.asarray(ref.includemargin)
    g_act = got.dist.numpy() < got.includemargin.numpy()
    np.testing.assert_array_equal(g_act, r_act)
    assert r_act.any(), "fixture state has no active contact"
    for name in ("geom1", "geom2"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[g_act],
                                      np.asarray(getattr(ref, name))[r_act])
    for name, atol in (("dist", atol_d), ("pos", atol_p), ("frame", atol_f)):
        np.testing.assert_allclose(getattr(got, name).numpy()[g_act],
                                   np.asarray(getattr(ref, name))[r_act],
                                   rtol=0, atol=atol, err_msg=name)
    return int(r_act.sum())


@pytest.fixture(scope="module")
def f64_pair():
    return torch_model(full=False)


@pytest.mark.parametrize("drop", DROPS)
def test_contacts_f64_match_jax_xla(f64_pair, drop):
    jm, tm = f64_pair
    assert tm.mesh_kernel[1] is not None  # f64 still takes the XLA port
    qpos = poses(tm, drop)
    ref = jax_contacts(jm, qpos)
    got = torch_contacts(tm, qpos)
    assert got.dist.shape == tuple(np.asarray(ref.dist).shape)
    np.testing.assert_array_equal(got.dim, np.asarray(ref.dim))
    assert_active_match(ref, got, 1e-9, 1e-9, 1e-9)
    # both XLA paths rank the same exact keys: every slot agrees
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def f32_pair():
    with jax.enable_x64(False):
        jm = jax_model(full=False, dtype=jnp.float32)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device="cpu",
                                    dtype=torch.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jpc, "_INTERPRET", True)
    monkeypatch.setattr(jpc, "pallas_enabled", lambda: True)
    jcoll._PALLAS_SELECT_CACHE.clear()
    jcoll._PALLAS_TOPK_CACHE.clear()
    yield
    jcoll._PALLAS_SELECT_CACHE.clear()
    jcoll._PALLAS_TOPK_CACHE.clear()


def test_pack_tables_match_reference(f32_pair):
    """The port's copy of pack_plane_mesh_buckets builds the same tables."""
    jm, tm = f32_pair
    g = tm.groups[1]
    ref = jpc.pack_plane_mesh_buckets(jm, g.pair_ids, tm.mesh_vertmask.shape[1])
    plan = tm.mesh_kernel[1]
    assert len(ref[0]) == len(plan.buckets) > 1
    np.testing.assert_array_equal(g.pair_ids[ref[1]], plan.pid)
    for (ids, (tb, shape), marg, D), (_, n, d2, tbl, m2) in zip(ref[0],
                                                                plan.buckets):
        assert D == d2 and n == len(ids)
        np.testing.assert_array_equal(
            np.frombuffer(tb, np.float32).reshape(shape), tbl)
        np.testing.assert_array_equal(np.asarray(marg, np.float32), m2)


@pytest.mark.parametrize("drop", DROPS)
def test_select_plain_matches_pallas(f32_pair, pallas_interpret, drop):
    """manifold_plain (the select's part of mesh_slots_plain) against
    _select_batched_raw, bucket by bucket."""
    jm, tm = f32_pair
    plan = tm.mesh_kernel[1]
    d = kinematics.kinematics(tm, tio.make_data(tm, E).replace(
        qpos=torch.as_tensor(poses(tm, drop), dtype=torch.float32)))
    t = plan.tensors("cpu")
    a, b = hc.plane_in_mesh_frame(d.geom_xpos, d.geom_xmat, t.pg1, t.pg2)
    dist, vsel = hc.manifold_plain(t.verts, t.vmask, t.nbr,
                                   np.zeros(plan.P, bool), a, b,
                                   t.pair_f[:, 0], t.pair_f[:, 1])
    # env-last, as the reference's kernel writes them
    dist = dist.permute(1, 2, 0).numpy()
    vsel = vsel.reshape(E, plan.P, 9).permute(1, 2, 0).numpy()
    subs, _ = jpc.pack_plane_mesh_buckets(jm, tm.groups[1].pair_ids,
                                          tm.mesh_vertmask.shape[1])
    n_act = 0
    with jax.enable_x64(False):
        for (ids, tbl_t, marg, D), (start, n, _, _, _) in zip(subs,
                                                             plan.buckets):
            s = slice(start, start + n)
            rd, rv = jpc._select_batched_raw(
                tbl_t, jnp.asarray(a[:, s].numpy()),
                jnp.asarray(b[:, s].numpy()), marg, D)
            rd, rv = np.asarray(rd)[..., :E], np.asarray(rv)[..., :E]
            margin = plan.pair_f[s, 0][:, None, None]
            act = rd < margin
            np.testing.assert_array_equal(dist[s] < margin, act)
            np.testing.assert_allclose(dist[s][act], rd[act], rtol=0,
                                       atol=1e-6)
            act9 = np.repeat(act, 3, axis=1)
            np.testing.assert_allclose(vsel[s][act9], rv[act9], rtol=0,
                                       atol=1e-5)
            n_act += int(act.sum())
    assert n_act > 0


@pytest.mark.parametrize("drop", DROPS)
def test_kernel_path_contacts_match_pallas(f32_pair, pallas_interpret, drop):
    """select + top-K: the port's kernel path (plain versions on the CPU)
    against the JAX Pallas kernels in interpret mode."""
    jm, tm = f32_pair
    qpos = poses(tm, drop).astype(np.float32)
    with jax.enable_x64(False):
        ref = jax_contacts(jm, qpos)
    got = torch_contacts(tm, qpos)
    assert_active_match(ref, got, 1e-6, 1e-5, 1e-6)


@pytest.mark.parametrize("shape", [(8, 5, 3), (8, 7), (128, 256)])
def test_moveaxis_matches_pallas_layout(monkeypatch, shape):
    """(128, 256) runs the Pallas _t2d kernel in interpret mode."""
    monkeypatch.setattr(jpn, "_INTERPRET", True)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    with jax.enable_x64(False):
        last = np.asarray(jlay.moveaxis0_last(jnp.asarray(x)))
        back = np.asarray(jlay.moveaxis_last0(jnp.asarray(last)))
    got = lay.moveaxis0_last(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), last)
    np.testing.assert_array_equal(lay.moveaxis_last0(got).numpy(), back)


@pytest.mark.parametrize("E_, K", [(8, 12), (100, 3), (130, 24)])
def test_grouped_matches_pallas_layout(monkeypatch, E_, K):
    """to_grouped's (K, R, 128) with the (R, 128) split dropped is (K, E)."""
    monkeypatch.setattr(jpn, "_INTERPRET", True)  # CPU: XLA relayout
    x = np.random.default_rng(1).normal(size=(E_, K)).astype(np.float32)
    with jax.enable_x64(False):
        g = jlay.to_grouped(jnp.asarray(x))
        back = np.asarray(jlay.from_grouped(g, E_))
        g = np.asarray(g)
    got = lay.to_grouped(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(),
                                  g.reshape(K, -1)[:, :E_])
    np.testing.assert_array_equal(lay.from_grouped(got).numpy(), back)
