"""The plane-mesh kernel's plain version and its wrapper on the CPU.

* `hopper_collision.mesh_slots_plain` (the plain version of
  `csrc/plane_mesh.cu`) on the small fixture (10 hulls, k 4), at three
  drops, against the JAX package's `make_group_topk` in interpret mode
  (the select and top-K Pallas kernels), reached through its collision as
  tests/test_torch_collision.py reaches it, compiled once for the module:
  active masks and geom ids exact, dist atol 1e-6, pos atol 1e-5, frame
  atol 1e-6 on active slots (on inactive ones the reference writes its
  conservative bound).
* The same at k = P, where the port ranks every pair (the mega kernels'
  order, `pair_topk(ranked=True)`), against the JAX package's XLA
  narrowphase at k = P (its staged path, which keeps the pairs in order):
  the active ranks hold the pairs whose key is below 0, deepest first
  (first index on ties), each with the reference's slots of that pair.
* The wrapper's plumbing through a stand-in launcher (`_MeshSlots` of
  tests/test_torch_layout.py): one launch, the key output, a ragged and a
  single env; and its checks (shapes, float32, contiguity, k <= P, the
  pair limit), which raise before any launch.
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
from loco_mujoco_tpu.ops import pallas_collision as jpc
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import hopper_collision as hc
from loco_mujoco_tpu_torch.ops import kernels, kinematics
from test_torch_collision import DROPS, E, poses
from test_torch_fixture import export_model, jax_model
from test_torch_layout import _MeshSlots

GROUP = 1  # the fixture's plane-mesh group


@pytest.fixture(scope="module")
def f32_pair():
    with jax.enable_x64(False):
        jm = jax_model(full=False, dtype=jnp.float32)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device="cpu",
                                    dtype=torch.float32)


def _contacts_fn(jm):
    """The reference's collision over a batch of qpos, jitted once."""
    d0 = jax_make_data(jm)

    def one(q):
        return jcoll.collision(jm, jkin.kinematics(jm, d0.replace(qpos=q)))

    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def pallas_contacts(f32_pair):
    """The reference's contacts with its Pallas select and top-K kernels in
    interpret mode (one compile for the module's drops)."""
    jm, _ = f32_pair
    fn = _contacts_fn(jm)

    def contacts(q):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpc, "_INTERPRET", True)
            mp.setattr(jpc, "pallas_enabled", lambda: True)
            out = fn(q).contact
            jcoll._PALLAS_SELECT_CACHE.clear()
            jcoll._PALLAS_TOPK_CACHE.clear()
            return out

    return contacts


def _poses(tm, drop):
    d = tio.make_data(tm, E).replace(
        qpos=torch.as_tensor(poses(tm, drop), dtype=torch.float32))
    return kinematics.kinematics(tm, d)


@pytest.mark.parametrize("drop", DROPS)
def test_mesh_slots_plain_matches_pallas(f32_pair, pallas_contacts, drop):
    jm, tm = f32_pair
    g, plan = tm.groups[GROUP], tm.mesh_kernel[GROUP]
    assert plan is not None and plan.k < plan.P
    with jax.enable_x64(False):
        ref = pallas_contacts(jnp.asarray(poses(tm, drop), jnp.float32))
    d = _poses(tm, drop)
    got = hc.mesh_slots_plain(plan, d.geom_xpos, d.geom_xmat)
    n = g.k * g.slots
    sl = slice(g.offset, g.offset + n)
    r_act = np.asarray(ref.dist)[:, sl] < np.asarray(ref.includemargin)[:, sl]
    g_act = (got[0] < got[8][..., None]).reshape(E, n).numpy()
    np.testing.assert_array_equal(g_act, r_act)
    assert r_act.any(), "no active plane-mesh slot"
    slot = torch.as_tensor(g_act.reshape(E, g.k, 3)[..., 0])
    for i, name in ((3, "geom1"), (4, "geom2")):
        np.testing.assert_array_equal(
            got[i][slot].numpy(),
            np.asarray(getattr(ref, name))[:, sl].reshape(E, g.k, 3)[..., 0]
            [slot.numpy()])
    for i, name, atol, tail in ((0, "dist", 1e-6, ()), (1, "pos", 1e-5, (3,)),
                                (2, "frame", 1e-6, (3, 3))):
        r = np.asarray(getattr(ref, name))[:, sl].reshape(E, g.k, 3, *tail)
        gv = got[i].numpy()
        if name == "frame":  # one per pair: the rank's first slot's
            r = r[:, :, 0]
            np.testing.assert_allclose(gv[slot.numpy()], r[slot.numpy()],
                                       rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(gv.reshape(E, n, *tail)[g_act],
                                       r.reshape(E, n, *tail)[r_act],
                                       rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def kp_pair(f32_pair):
    """The fixture at k = P: the reference's staged XLA contacts (pairs in
    order), jitted once, and the port's plan ranked at k = P."""
    jm, tm = f32_pair
    plan = tm.mesh_kernel[GROUP]
    with jax.enable_x64(False):
        jkp = jm.replace(contact_k_plane=plan.P)
        fn = _contacts_fn(jkp)
    return (lambda q: fn(q).contact,
            dataclasses.replace(plan, k=plan.P, _dev={}))


@pytest.mark.parametrize("drop", DROPS)
def test_mesh_slots_plain_ranked_at_k_equals_p(f32_pair, kp_pair, drop):
    jm, tm = f32_pair
    xla, plan = kp_pair
    P = plan.P
    with jax.enable_x64(False):
        ref = xla(jnp.asarray(poses(tm, drop), jnp.float32))
    d = _poses(tm, drop)
    keys = torch.empty(E, P)
    got = hc.mesh_slots_plain(plan, d.geom_xpos, d.geom_xmat, keys)
    # the reference's slots of each pair, by its mesh geom, in plan order
    o = tm.groups[GROUP].offset
    sl = slice(o, o + 3 * P)
    r_g2 = np.asarray(ref.geom2)[:, sl].reshape(E, P, 3)[:, :, 0]
    where = np.stack([[int(np.nonzero(r_g2[e] == gid)[0][0])
                       for gid in plan.pg2] for e in range(E)])  # (E, P)

    def by_pair(name, *tail):
        x = np.asarray(getattr(ref, name))[:, sl].reshape(E, P, 3, *tail)
        return np.take_along_axis(
            x, where.reshape(E, P, *([1] * (x.ndim - 2))), axis=1)

    r_dist = by_pair("dist")
    r_key = r_dist[..., 0] - plan.tbl16[:, 0]
    n_act = 0
    for e in range(E):
        order = np.lexsort((np.arange(P), r_key[e]))  # key, first index
        act = int((r_key[e] < 0).sum())
        n_act += act
        on = got[0][e, :, 0] < hc.BIG / 2
        assert int(on.sum()) == act and bool(on[:act].all())
        sel = order[:act]
        np.testing.assert_array_equal(got[4][e, :act].numpy(),
                                      plan.pg2[sel])
        np.testing.assert_allclose(keys[e, sel].numpy(), r_key[e, sel],
                                   rtol=0, atol=1e-6)
        r_on = r_dist[e, sel] < np.asarray(ref.includemargin)[e, sl].reshape(
            P, 3)[where[e, sel]]
        g_on = (got[0][e, :act] < got[8][e, :act, None]).numpy()
        np.testing.assert_array_equal(g_on, r_on)
        np.testing.assert_allclose(got[0][e, :act].numpy()[g_on],
                                   r_dist[e, sel][r_on], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1][e, :act].numpy()[g_on],
                                   by_pair("pos", 3)[e, sel][r_on], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[2][e, :act].numpy(),
                                   by_pair("frame", 3, 3)[e, sel][:, 0],
                                   rtol=0, atol=1e-6)
    assert n_act > 0


@pytest.fixture
def on_card(f32_pair, monkeypatch):
    """CPU tensors through the kernel path: `is_cuda` True, the stand-in
    launcher of the fixture's plan, a null stream."""
    _, tm = f32_pair
    lib = _MeshSlots(tm.mesh_kernel[GROUP])
    monkeypatch.setattr(kernels, "library",
                        lambda name, signatures, defines=(): lib)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    kernels.LAUNCHES.clear()
    yield lib
    kernels.LAUNCHES.clear()


@pytest.mark.parametrize("n", [1, 5])
def test_mesh_slots_launch_and_keys(f32_pair, on_card, n):
    """One launch on the poses as they come (a single env, a ragged
    count), the slots and the key output those of the plain version, the
    dense outputs contiguous."""
    _, tm = f32_pair
    plan = tm.mesh_kernel[GROUP]
    d = _poses(tm, 0.02)
    gxp, gxm = d.geom_xpos[:n].contiguous(), d.geom_xmat[:n].contiguous()
    keys = torch.empty(n, plan.P)
    got = hc.mesh_slots(plan, gxp, gxm, keys)
    assert dict(kernels.LAUNCHES) == {"mesh_slots": 1}
    assert on_card.launches == [(plan.P, plan.k, n, tm.ngeom, True)]
    want = torch.empty(n, plan.P)
    ref = hc.mesh_slots_plain(plan, gxp, gxm, want)
    assert torch.equal(keys, want)
    for r, k in zip(ref, got):
        assert k.dtype == r.dtype and torch.equal(k, r)
    assert all(x.is_contiguous() for x in got[:3])
    assert got[3].dtype == torch.int64


@pytest.mark.parametrize("bad, error, match", [
    ("shape", ValueError, "geom_xmat"),
    ("float64", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
    ("keys", ValueError, "key_out"),
    ("k", ValueError, "k <= P"),
    ("pairs", ValueError, "k <= P"),
])
def test_mesh_slots_checks_raise(f32_pair, on_card, monkeypatch, bad, error,
                                 match):
    """Bad operands or a plan past the kernel's limits raise before any
    launch; nothing falls back."""
    _, tm = f32_pair
    plan = tm.mesh_kernel[GROUP]
    d = _poses(tm, 0.02)
    gxp, gxm, keys = d.geom_xpos, d.geom_xmat, None
    if bad == "shape":
        gxm = gxm.reshape(E, -1, 9)
    elif bad == "float64":
        gxp = gxp.double()
    elif bad == "strided":
        gxm = gxm.transpose(2, 3)
    elif bad == "keys":
        keys = torch.empty(E, plan.P + 1)
    elif bad == "k":
        plan = dataclasses.replace(plan, k=plan.P + 1, _dev={})
    else:
        monkeypatch.setattr(hc, "MAX_PAIRS", plan.P - 1)
    with pytest.raises(error, match=match):
        hc.mesh_slots(plan, gxp, gxm, keys)
    assert on_card.launches == [] and not kernels.LAUNCHES
