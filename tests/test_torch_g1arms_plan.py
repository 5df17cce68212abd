"""G1 with its arms (nv 29) and the kernels' second compiled width, on the
CPU: the committed stand-in, its plans and its launch.

`UnitreeG1(disable_arms=False)` keeps the 10 hinges of `ARMS`
(`models/humanoids/unitree_g1.py:25-32`), so nv is 29, past the first
width the kernels are compiled at (24). The stand-in is
`test_torch_g1_fixture.g1_xml(arms=True)`: G1's default shape with two
arms of five limited hinges and motors under the torso, a forearm capsule
each (the plane-capsule group, beside the toe rollers) and a hand hull
each (the plane-mesh group): nv 29, 25 bodies, 23 limited hinges and
motors, 72 slots, 312 rows (the reference's comment puts G1 with arms at
320, `ops/pallas_constraint.py:205`; forearm capsules of 2 slots each
cannot add the 8 rows to that count cleanly).

- The JAX package's own `RowPlan` of the committed model takes the mega
  path with the extended collision (`mega`, `mega_ell`), pyramidal cones
  and a plane-mesh group: the reference's own path at nv 29; the port's
  plan matches it field for field.
- Each plan records the width it needs (`nvm`): 24 for every earlier
  stand-in, 32 for G1 with its arms and its small variant (nv 25); nv 33
  gets no plan, and the Newton kernel's wrapper refuses it.
- The launch keeps the rows' J in a global scratch (J in shared memory
  would leave 3 resident warps per SM, under `RESIDENT_FLOOR`); the
  wrappers load the libraries compiled at 32 and pass the scratch; the
  damping rows' instance loads the wide library too, and only an elliptic
  plan there, which the wide library does not hold, raises; the I_SHM
  tables of the earlier stand-ins are as they were.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_g1_fixture as g1fx
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.envs import standins
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from loco_mujoco_tpu_torch.ops import hopper_newton as hn
from loco_mujoco_tpu_torch.ops import kernels
from loco_mujoco_tpu_torch.ops import plan as tplan
from test_torch_fixture import _same, export_model
from test_torch_h1_fixture import census

ASSETS = g1fx.ASSET_ARMS.parent
# (t1, t2, condim, k, pairs) of each contact group
CENSUS_ARMS = [(0, 2, 3, 8, 8), (0, 3, 3, 4, 4), (0, 7, 3, 8, 20),
               (2, 2, 3, 8, 16), (2, 3, 3, 8, 24), (3, 3, 3, 8, 9)]
CENSUS_ARMS_SMALL = [(0, 2, 3, 4, 4), (0, 3, 3, 4, 4), (0, 7, 3, 4, 12),
                     (2, 2, 3, 2, 4), (2, 3, 3, 2, 4), (3, 3, 3, 1, 1)]
# the I_SHM tables (ops/plan.py SHM order) of the earlier stand-ins' mega
# launches, as they were before the second width
I_SHM = {
    "humanoid_torque_shape": [6108, 0, 304, 532, 648, 1188, 1552, 1932, 4668,
                              5820, 5824, 5828, 5832, 1932, 6088, 6092, 19,
                              144, 8, 75, 8],
    "humanoid_muscle_shape": [6436, 0, 304, 532, 648, 1188, 1552, 1932, 4668,
                              5820, 5824, 5828, 5832, 1932, 6088, 6420, 19,
                              144, 8, 75, 8],
    "unitree_a1_shape": [13996, 0, 288, 504, 612, 1452, 1776, 2604, 8304,
                         11904, 11916, 11928, 12004, 2604, 13524, 13528, 19,
                         300, 20, 12, 8],
    "unitree_a1_position_shape": [13996, 0, 288, 504, 612, 1452, 1776, 2604,
                                  8304, 11904, 11916, 11928, 12004, 2604,
                                  13524, 13528, 19, 300, 20, 12, 8],
    "unitree_h1_shape": [6472, 0, 272, 476, 580, 1120, 1412, 1720, 4712,
                         6120, 6124, 6128, 6132, 1720, 6452, 6456, 17, 176,
                         8, 17, 8],
    "atlas_shape": [10064, 0, 304, 532, 648, 1428, 1792, 2172, 7340, 9516,
                    9520, 9524, 9528, 2172, 10040, 10044, 19, 272, 8, 12, 8],
    "unitree_g1_shape": [11464, 0, 304, 532, 648, 1548, 1912, 2292, 7764,
                         10068, 10072, 10076, 10080, 2292, 11440, 11444, 19,
                         288, 20, 24, 8],
}


@pytest.fixture(scope="module")
def arms():
    return tio.load_model_npz(g1fx.ASSET_ARMS, device="cpu")


def test_g1arms_census_and_plans(arms, monkeypatch):
    """The committed stand-in's census, and its plan: the JAX package's
    own (mega, mega_ell, pyramidal cones, a plane-mesh group) and the
    port's, equal field for field, at width 32."""
    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.models.humanoids.unitree_g1 import ARMS
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin

    m = arms
    assert (m.nv, m.nu, m.njnt, m.nbody) == (29, 23, 29, 25)
    assert m.nbody <= tplan.BODY_MAX and int(m.jnt_limited.sum()) == 23
    assert set(ARMS) <= set(m.names["joint"])
    assert m.opt.cone == 0 and m.opt.integrator == 0
    assert census(m) == CENSUS_ARMS
    tp = m.plan
    assert tp.mega and tp.mega_ell and not tp.elliptic and tp.euler_dv
    assert (tp.ncon, tp.nrows, tp.nvm) == (72, 312, 32)
    assert tp.nrows <= tplan.ROWS_MAX and hm.ext_mode(tp) == 2
    assert standins.standin_kind(m) == "g1"
    assert os.path.getsize(g1fx.ASSET_ARMS) < 512 * 1024
    vcap = max(m.mesh_vert.shape[1], 8)
    monkeypatch.setenv("LMT_MESH_VCAP", str(vcap))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    with jax.enable_x64(False):
        jm = g1fx.jax_model(True, dtype=jnp.float32, arms=True)
        jd = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
        jp = pc.get_plan(jm, jd.contact)
    assert jp is not None and jp.mega and jp.mega_ell and not jp.elliptic
    assert ("plane", "mesh") in [g["kind"] for g in jp.colp.groups]
    for field in ("elliptic", "mega_ell", "mega", "euler_dv", "smooth",
                  "uniform", "pack_w", "nfric", "nrows", "npad", "ncon",
                  "ne", "nfl", "nl", "rows_per"):
        got, ref = getattr(tp, field), getattr(jp, field)
        assert (list(got) if field == "rows_per" else got) == ref, field
    np.testing.assert_array_equal(tp.con_efcadr, jp.con_efcadr)
    np.testing.assert_array_equal(tp.con_dim, jp.con_dim)


def test_committed_g1arms_npz_matches_generator(tmp_path):
    """Drift test: the committed model is what the generator makes now,
    leaf for leaf."""
    fresh = tmp_path / "fresh.npz"
    g1fx.write_full_width(fresh, arms=True)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(g1fx.ASSET_ARMS)
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k


def test_small_arms_variant_crosses_the_width():
    """The float32 mega test's variant (the small legs, the arms): nv 25,
    past the first width, on the extended pyramidal plan."""
    _, small = g1fx.torch_model(full=False, dtype=torch.float32, arms=True)
    assert small.nv == 25 and census(small) == CENSUS_ARMS_SMALL
    sp = small.plan
    assert sp.mega_ell and not sp.elliptic and sp.nvm == 32
    assert (sp.ncon, sp.nrows) == (30, 144)


def test_plans_pick_their_width(arms):
    """Every earlier stand-in is planned at width 24, G1 with its arms at
    32; `kernels.nv_width` is the narrowest width that holds nv."""
    assert kernels.NV_WIDTHS == (24, 32) and tplan.NV_MAX == 32
    for name in I_SHM:
        assert tio.load_model_npz(ASSETS / f"{name}.npz",
                                  device="cpu").plan.nvm == 24, name
    assert arms.plan.nvm == 32
    assert [kernels.nv_width(n) for n in (1, 24, 25, 32, 33)] == [
        24, 24, 32, 32, None]
    assert kernels.width_defines(24) == ()
    assert kernels.width_defines(32) == ("LMT_NVM=32",)
    libs = kernels.libraries()
    assert sorted((n, d) for n, d in libs if d) == [
        ("fused", ("LMT_NVM=32",)), ("mega", ("LMT_NVM=32",)),
        ("newton", ("LMT_NVM=32",))]


def test_g1arms_launch_keeps_j_in_global_scratch(arms, monkeypatch):
    """J of 312 rows at nv 29 in shared memory would leave 3 resident
    warps per SM: the launch keeps it in a global scratch (E x nrows x
    NVJ floats, made once per env count) and the shared region J holds
    only the scratch that aliases it; an earlier stand-in keeps J in
    shared memory and takes no scratch."""
    launch = tplan.mega_launch(arms.plan)
    c = tplan.mega_census(arms.plan)
    assert launch.j_global and launch.resident_warps >= tplan.RESIDENT_FLOOR
    nvj = launch.extra["NVJ"]
    assert nvj == 29
    shared_j = launch.offset["ROW"] - launch.offset["J"]
    scratch = max(12 * c["nv"], 3 * max(c["pairs"]) + 2 * max(c["ks"]))
    assert shared_j == -(-scratch // 4) * 4 < c["nrows"] * nvj
    assert launch.offset["MESH"] == launch.offset["J"]
    assert launch.shared_bytes <= tplan.SHM_PER_BLOCK
    J = launch.jrows(4096, "cpu")
    assert J.shape == (4096, 312, 29) and J.dtype == torch.float32
    assert launch.jrows(4096, "cpu") is J  # kept for the next launches
    monkeypatch.setattr(tplan, "RESIDENT_FLOOR", 3)
    in_shared = tplan.MegaLaunch(c)
    assert not in_shared.j_global and in_shared.resident_warps == 3
    g1 = tio.load_model_npz(ASSETS / "unitree_g1_shape.npz", device="cpu")
    assert tplan.mega_launch(g1.plan).jrows(8, "cpu") is None


def _chain_model(n_hinges):
    """An inline chain of `n_hinges` limited hinges on a free-standing
    root of 3 slides and 3 hinges (nv = n_hinges + 6), a capsule at its
    tip against the floor."""
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    body = ('<geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.1" '
            'contype="2" conaffinity="1"/>')
    for i in reversed(range(n_hinges)):
        body = (f'<body name="b{i}" pos="0 0 -0.05"><inertial pos="0 0 0" '
                f'mass="0.1" diaginertia="1e-4 1e-4 1e-4"/><joint '
                f'name="h{i}" axis="{"010" if i % 2 else "100"}" '
                f'range="-1 1"/>{body}</body>').replace(
                    'axis="010"', 'axis="0 1 0"').replace(
                    'axis="100"', 'axis="1 0 0"')
    root = "".join(f'<joint name="r{k}" type="{t}" axis="{a}" '
                   f'limited="false"/>' for k, (t, a) in enumerate(
                       [("slide", "1 0 0"), ("slide", "0 1 0"),
                        ("slide", "0 0 1"), ("hinge", "1 0 0"),
                        ("hinge", "0 1 0"), ("hinge", "0 0 1")]))
    xml = f"""<mujoco><option integrator="Euler" iterations="8"
      ls_iterations="8"/><default><joint limited="true"/></default>
      <worldbody><geom name="floor" type="plane" size="0 0 0.05"
      contype="1" conaffinity="2"/><body name="root" pos="0 0 2">
      <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
      {root}{body}</body></worldbody></mujoco>"""
    jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
    leaves, aux = export_model(jm)
    return tio.model_from_numpy(leaves, aux, device="cpu",
                                dtype=torch.float32)


def test_nv33_gets_no_plan(monkeypatch):
    """nv 32 is planned at width 32; nv 33, past every compiled width,
    gets no plan, and the standalone Newton kernel's wrapper refuses its
    rows on a CUDA tensor (the recorded library is never reached)."""
    m32, m33 = _chain_model(26), _chain_model(27)
    assert m32.nv == 32 and m32.plan is not None and m32.plan.nvm == 32
    assert m33.nv == 33 and m33.plan is None
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(kernels, "library", lambda *a, **k: pytest.fail(
        "the Newton library was loaded for nv 33"))
    E, nefc, nv = 2, 4, 33
    z = lambda *s: torch.zeros(s)  # noqa: E731
    with pytest.raises(NotImplementedError, match="no compiled width"):
        hn.solve(z(E, nefc, nv), z(E, nv, nv), z(E, nefc), z(E, nefc),
                 z(E, nefc), z(E, nefc), z(E, nefc), z(E, nv), z(E, nv),
                 ne=0, nfl=0, iterations=8, ls_iterations=8, scale=1.0,
                 tol=1e-6)


class _Recorder:
    """Stands in for a compiled library: records the macros it was loaded
    with and each launcher's arguments."""

    def __init__(self, defines):
        self.defines, self.calls = tuple(defines), {}

    def __getattr__(self, fn):
        def call(*args):
            self.calls[fn] = args
            return 0
        return call


def _record(monkeypatch):
    libs = {}

    def library(name, signatures, defines=()):
        libs[name] = _Recorder(defines)
        return libs[name]

    monkeypatch.setattr(kernels, "library", library)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    return libs


def test_wrappers_load_the_wide_libraries(arms, monkeypatch):
    """On a CUDA tensor G1 with its arms loads the mega and fused
    libraries compiled at 32 and passes the mega kernels its J scratch
    (the pointer after the last output); G1 loads the libraries without
    the macro and passes no scratch."""
    libs = _record(monkeypatch)
    E = 5
    g1 = tio.load_model_npz(ASSETS / "unitree_g1_shape.npz", device="cpu")
    for m, wide in ((arms, True), (g1, False)):
        want = ("LMT_NVM=32",) if wide else ()
        d = tio.make_data(m, E)
        hm.mega_forward(m, d)
        assert libs["mega"].defines == want
        J = tplan.mega_launch(m.plan).jrows(E, "cpu")
        got = libs["mega"].calls["lmt_mega_forward"][24]
        assert (got is None) == (not wide)
        if wide:
            assert got == J.data_ptr()
        hm.mega_step_n(m, d, 2)
        got = libs["mega"].calls["lmt_megastep"][15]
        assert (got is None) == (not wide)
        hf.fused_constraint(m, d)
        assert libs["fused"].defines == want


def test_uncompiled_wide_instance_raises(arms, monkeypatch):
    """The wide mega library holds every instance but the extended
    elliptic one: the damping rows' instance (G1 with its arms under
    damping randomization) and the plane-only instance load it, and only
    an elliptic plan at width 32 raises, before any library is loaded."""
    libs = _record(monkeypatch)
    E = 3
    dyn = arms.replace(plan=arms.plan.dyn_damping())
    d = tio.make_data(dyn, E).replace(
        dof_damping=arms.dof_damping.expand(E, -1).contiguous())
    monkeypatch.setattr(hm, "ext_mode", lambda plan: 1)
    with pytest.raises(NotImplementedError, match="no elliptic instance"):
        hm.library(arms.plan)
    assert "mega" not in libs
    monkeypatch.undo()
    libs = _record(monkeypatch)
    hm.mega_forward(dyn, d)
    assert libs["mega"].defines == ("LMT_NVM=32",)
    assert libs["mega"].calls["lmt_mega_forward"][9] is not None
    monkeypatch.setattr(hm, "ext_mode", lambda plan: 0)
    assert hm.library(arms.plan).defines == ("LMT_NVM=32",)


def test_committed_i_shm_tables_unchanged():
    """Every earlier stand-in's packed I_SHM table is as it was."""
    for name, table in I_SHM.items():
        m = tio.load_model_npz(ASSETS / f"{name}.npz", device="cpu")
        ints, _ = m.plan.pack()
        at = int(ints[tplan.H["I_SHM"]])
        assert list(ints[at:at + len(tplan.SHM)]) == table, name
        assert not tplan.mega_launch(m.plan).j_global, name
