"""The port's relayouts (`hopper_layout`) on the CPU.

* The list forms' plain version against the JAX package's
  `pallas_layout` functions, array by array, bit-exact, on lists that mix
  shapes: E not a multiple of 32, K < 8, K = 1, and one (128, 256) array
  that runs the reference's `_t2d` Pallas kernel in interpret mode.
* The kernel path's plumbing with the launcher replaced by a stand-in
  that does what `csrc/layout.cu` does (each packed (x, y, R, C) array
  transposed through its pointers): the operand checks, the outputs' one
  buffer at 16-byte offsets, one launch per list, and the two call sites
  that relayed operands before their kernels read them env-major:
  `collision._plane_mesh_kernel`, one `mesh_slots` launch on the geom
  poses as Data holds them (bit for bit against its plain version; the
  plane-mesh launcher a stand-in, `_MeshSlots`, that runs
  `mesh_slots_plain` on the poses it reads back through its pointers),
  and `hopper_newton.solve` (the Newton launcher a stand-in that runs
  `newton_plain` on the operands it reads back through its pointers);
  neither launches a relayout.
"""

import ctypes
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.ops import pallas_layout as jlay
from loco_mujoco_tpu.ops import pallas_newton as jpn
from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.ops import collision, kinematics, kernels
from loco_mujoco_tpu_torch.ops import hopper_collision as hc
from loco_mujoco_tpu_torch.ops import hopper_layout as lay
from loco_mujoco_tpu_torch.ops import hopper_newton as hn
from test_torch_fixture import ASSET
from test_torch_newton import ITER, LS, NE, NFL, SCALE, TOL, problem

# (E, *rest) arrays of one list: E 45 (not a multiple of 32), K 7 (< 8),
# K 1, a 3-d array, and the (128, 256) array of the reference's kernel
ENV_MAJOR = [(45, 7), (45, 1), (45, 5, 3), (128, 256)]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_moveaxis_many_matches_pallas_layout(monkeypatch):
    monkeypatch.setattr(jpn, "_INTERPRET", True)
    xs = [_x(s, i) for i, s in enumerate(ENV_MAJOR)]
    got = lay.moveaxis0_last_many(*map(torch.as_tensor, xs))
    back = lay.moveaxis_last0_many(*got)
    assert len(got) == len(back) == len(xs)
    with jax.enable_x64(False):
        for x, g, b in zip(xs, got, back):
            last = np.asarray(jlay.moveaxis0_last(jnp.asarray(x)))
            np.testing.assert_array_equal(g.numpy(), last)
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(jlay.moveaxis_last0(jnp.asarray(last))))


def test_grouped_many_matches_pallas_layout(monkeypatch):
    """to_grouped's (K, R, 128) with the (R, 128) split dropped is (K, E)."""
    monkeypatch.setattr(jpn, "_INTERPRET", True)
    xs = [_x(s, 10 + i) for i, s in enumerate(
        [(45, 7), (45, 1), (130, 24), (128, 256)])]
    got = lay.to_grouped_many(*map(torch.as_tensor, xs))
    back = lay.from_grouped_many(*got)
    with jax.enable_x64(False):
        for x, g, b in zip(xs, got, back):
            E_, K = x.shape
            ref = jlay.to_grouped(jnp.asarray(x))
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(ref).reshape(K, -1)[:, :E_])
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(jlay.from_grouped(ref, E_)))


@pytest.mark.parametrize("role", ["moveaxis0_last", "moveaxis_last0",
                                  "to_grouped", "from_grouped"])
def test_one_array_form_is_the_list_of_one(role):
    x = torch.as_tensor(_x((45, 7), 3))
    one = getattr(lay, role)(x)
    (many,) = getattr(lay, f"{role}_many")(x)
    assert torch.equal(one, many) and torch.equal(one, x.t())


def _read(ptr, shape, ctype=ctypes.c_float):
    """A writable numpy view of the memory at ptr."""
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class _Layout:
    """Stand-in for `csrc/layout.cu`'s launcher on CPU memory: each packed
    (x, y, R, C) array transposed through its pointers; records (R, C) of
    each launch's arrays."""

    def __init__(self):
        self.launches = []

    def lmt_transpose_many(self, packed, n, stream):
        assert 0 < n <= lay.MAX_ARRAYS and stream == 0
        q = struct.unpack(f"{4 * n}q", packed)
        self.launches.append([q[4 * k + 2:4 * k + 4] for k in range(n)])
        for k in range(n):
            x, y, R, C = q[4 * k:4 * k + 4]
            assert y % 16 == 0, "an output off its 16-byte offset"
            _read(y, (C, R))[...] = _read(x, (R, C)).T
        return 0


class _Newton:
    """Stand-in for `csrc/newton.cu`'s launcher: reads the env-major
    operands back through their pointers, solves them with `newton_plain`
    and writes the env-major results and decisions; records the launch's
    shared-memory table and geometry."""

    def __init__(self):
        self.launches = []

    def lmt_newton_solve(self, J, M, aref, D, R, fl, act, asm, ws, x, f,
                         iters, taken, ls_out, rows_out, shm, E, nv, nefc,
                         ne, nfl, it, ls, env_floats, envs_per_block, scale,
                         tol, stream):
        def read(p, *shape):
            return torch.as_tensor(_read(p, (E, *shape)).copy())

        self.launches.append((list(_read(shm, (len(hn.solve_launch(
            nv, nefc, ne, nfl).table()),), ctypes.c_int32)), env_floats,
            envs_per_block))
        rec = {}
        out = hn.newton_plain(
            read(J, nefc, nv), read(M, nv, nv), read(aref, nefc),
            read(D, nefc), read(R, nefc), read(fl, nefc), read(act, nefc),
            read(asm, nv), read(ws, nv), ne=ne, nfl=nfl, iterations=it,
            ls_iterations=ls, scale=scale, tol=tol, record=rec)
        _read(x, (E, nv))[...] = out[0].numpy()
        _read(f, (E, nefc))[...] = out[1].numpy()
        _read(iters, (E,), ctypes.c_int32)[...] = out[2].numpy()
        _read(taken, (E,), ctypes.c_int32)[...] = out[3].numpy()
        _read(ls_out, (E, hn.LS_WORDS), ctypes.c_int32)[...] = \
            rec["ls"].numpy()
        _read(rows_out, (E, it, hn.row_words(nefc)), ctypes.c_int32)[...] \
            = rec["rows"].numpy()
        return 0


_NEWTON = _Newton()


class _MeshSlots:
    """Stand-in for `csrc/plane_mesh.cu`'s launcher on CPU memory: checks
    that the plan's tables reach it, reads the env-major poses back
    through their pointers, runs `mesh_slots_plain` on them and writes the
    slots (and the keys, where a key pointer is given) through the output
    pointers; records (P, k, E, ngeom, keys given) of each launch."""

    def __init__(self, plan):
        self.plan, self.launches = plan, []

    def lmt_mesh_slots(self, gxp, gxm, tbl, pk, pf, st, env_id, dist, pos,
                       frame, ids, meta, key_out, P, k, E, G, tstride,
                       stream):
        t = self.plan.tensors("cpu")
        assert stream == 0 and env_id is None
        assert tstride == t.flat.numel()
        for p, ref, ctype in ((tbl, t.flat, ctypes.c_float),
                              (pk, t.pair_k, ctypes.c_int32),
                              (pf, t.pair_f, ctypes.c_float),
                              (st, t.tbl16, ctypes.c_float)):
            assert np.array_equal(_read(p, tuple(ref.shape), ctype),
                                  ref.numpy())
        self.launches.append((P, k, E, G, key_out is not None))
        xp = torch.as_tensor(_read(gxp, (E, G, 3)).copy())
        xm = torch.as_tensor(_read(gxm, (E, G, 3, 3)).copy())
        keys = None if key_out is None else torch.empty(E, P)
        out = hc.mesh_slots_plain(self.plan, xp, xm, keys)
        _read(dist, (E, k, 3))[...] = out[0].numpy()
        _read(pos, (E, k, 3, 3))[...] = out[1].numpy()
        _read(frame, (E, k, 3, 3))[...] = out[2].numpy()
        _read(ids, (E, k, 2), ctypes.c_int64)[...] = torch.stack(
            out[3:5], dim=-1).numpy()
        _read(meta, (E, k, hc.META))[...] = torch.cat(
            [*out[5:8], out[8][..., None]], dim=-1).numpy()
        if keys is not None:
            _read(key_out, (E, P))[...] = keys.numpy()
        return 0


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors through the kernel path: `is_cuda` True, the stand-in
    launchers, a null stream; yields the layout stand-in."""
    _NEWTON.launches.clear()
    libs = {"layout": _Layout(), "newton": _NEWTON}
    monkeypatch.setattr(kernels, "library",
                        lambda name, signatures, defines=(): libs[name])
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    kernels.LAUNCHES.clear()
    yield libs["layout"]
    kernels.LAUNCHES.clear()


@pytest.mark.parametrize("n", [1, 3, 16])
def test_list_launches_once(on_card, n):
    """n arrays of mixed shapes (ragged tiles, C % 4 != 0, R < 32, one
    element) in one launch, every result the plain version's."""
    shapes = [(45, 7), (1, 1), (19, 4096 // 64), (33, 130), (3, 2),
              (64, 5), (2, 70), (37, 37)] * 2
    xs = [torch.as_tensor(_x(s, i)) for i, s in enumerate(shapes[:n])]
    ys = lay.to_grouped_many(*xs)
    assert on_card.launches == [[tuple(x.shape) for x in xs]]
    assert dict(kernels.LAUNCHES) == {"to_grouped": 1}
    base = ys[0].data_ptr()
    for x, y in zip(xs, ys):
        assert torch.equal(y, x.t()) and y.is_contiguous()
        assert (y.data_ptr() - base) % 16 == 0


@pytest.mark.parametrize("bad, error, match", [
    ("many", ValueError, "at most 16"),
    ("float64", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
])
def test_list_checks_raise(on_card, bad, error, match):
    """Past MAX_ARRAYS arrays, a float64 or a non-contiguous operand, the
    list form raises before any launch; nothing falls back."""
    xs = [torch.zeros(8, 4) for _ in range(3)]
    if bad == "many":
        xs = [torch.zeros(8, 4)] * (lay.MAX_ARRAYS + 1)
    elif bad == "float64":
        xs[1] = xs[1].double()
    else:
        xs[2] = torch.zeros(4, 8).t()
    with pytest.raises(error, match=match):
        lay.moveaxis0_last_many(*xs)
    assert on_card.launches == [] and not kernels.LAUNCHES


def _dropped_state(model, E=6):
    rng = np.random.default_rng(2)
    qpos = model.qpos0.numpy()[None] + rng.normal(scale=0.02,
                                                  size=(E, model.nq))
    qpos[:, int(model.jnt_qposadr[model.names["joint"]["root_z"]])] -= 0.015
    d = io.make_data(model, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32))
    return kinematics.kinematics(model, d)


def test_plane_mesh_call_site(monkeypatch):
    """`_plane_mesh_kernel` launches `mesh_slots` once on the geom poses
    as Data holds them, with no relayout around it, and gives its plain
    version's slots bit for bit."""
    model = io.load_model_npz(ASSET, device="cpu", dtype=torch.float32)
    gi = next(i for i, p in enumerate(model.mesh_kernel) if p is not None)
    g, plan = model.groups[gi], model.mesh_kernel[gi]
    d = _dropped_state(model)
    ref = collision._plane_mesh_kernel(model, g, plan, d, plain=True)
    cpu = collision._plane_mesh_kernel(model, g, plan, d, plain=False)
    libs = {"layout": _Layout(), "plane_mesh": _MeshSlots(plan)}
    monkeypatch.setattr(kernels, "library",
                        lambda name, signatures, defines=(): libs[name])
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    kernels.LAUNCHES.clear()
    got = collision._plane_mesh_kernel(model, g, plan, d, plain=False)
    assert dict(kernels.LAUNCHES) == {"mesh_slots": 1}
    kernels.LAUNCHES.clear()
    assert libs["layout"].launches == []
    E = d.qpos.shape[0]
    assert libs["plane_mesh"].launches == [(plan.P, plan.k, E, model.ngeom,
                                            False)]
    assert bool((ref[0] < ref[8][..., None]).any()), "no active slot"
    for r, c, k in zip(ref, cpu, got):
        assert torch.equal(c, r) and torch.equal(k, r)


@pytest.mark.parametrize("nfl", [NFL, 0])
def test_newton_call_site(on_card, nfl):
    """`hopper_newton.solve` launches the Newton kernel once on its
    env-major operands as they come, with no relayout around it, and the
    kernel's stand-in, reading them through the pointers, gives
    `newton_plain`'s outputs and decisions bit for bit: every operand
    reaches its own argument, and the launch takes `plan.solve_launch`'s
    table and geometry."""
    p = problem(4)
    if not nfl:
        p["floss"][:] = 0
    args = [torch.as_tensor(p[k]) for k in ("J", "M", "aref", "D", "R",
                                            "floss", "active", "asm", "ws")]
    opts = dict(ne=NE, nfl=nfl, iterations=ITER, ls_iterations=LS,
                scale=SCALE, tol=TOL)
    rec = {}
    got = hn.solve(*args, **opts, record=rec)
    assert dict(kernels.LAUNCHES) == {"newton": 1}
    assert on_card.launches == []  # no relayout
    E, nefc, nv = args[0].shape
    launch = hn.solve_launch(nv, nefc, NE, nfl)
    assert _NEWTON.launches == [(launch.table(), launch.env_floats,
                                 launch.envs_per_block)]
    want = {}
    ref = hn.newton_plain(*args, **opts, record=want)
    for r, k in zip(ref, got):
        assert torch.equal(k, r)
    assert torch.equal(rec["ls"], want["ls"])
    assert torch.equal(rec["rows"], want["rows"])
