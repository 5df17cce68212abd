"""H1 and Atlas with their arms (nv 25 and 31) on the kernels' second
compiled width, on the CPU: the committed stand-ins, their plans and their
launches.

`UnitreeH1(disable_arms=False)` keeps the 8 hinges of its `ARMS`
(`models/humanoids/unitree_h1.py:28`) and `Atlas(disable_arms=False)` the
12 of its own (`atlas.py:27`), so nv is 25 and 31, past the first width
the kernels are compiled at (24). The stand-ins are
`test_torch_h1_fixture.h1_xml(arms=True)` (the arms' hulls in the
plane-mesh group: nv 25, 17 bodies, 40 slots, 184 rows) and
`test_torch_atlas_fixture.atlas_xml(arms=True)` (a forearm cylinder and a
hand box each in the top-K plane-cylinder and plane-box groups: nv 31, 25
bodies, 64 slots, 288 rows).

- The JAX package's own `RowPlan` of each committed model takes the mega
  path with the plane-only collision (`mega` set, `mega_ell` off): the
  reference's plane-only gate has no nv cap (`pallas_constraint.py:365`),
  its pyramidal rows stop at 400 (`:200-209`); the port's plan matches it
  field for field, at width 32.
- The launch keeps H1's J in shared memory (6 resident warps per SM) and
  Atlas's in the global scratch (J in shared memory would leave 3), so
  both placements run the plane-only instance.
- On a CUDA tensor the wrappers load the libraries compiled at 32 for the
  plane-only instance and its damping-rows variant, and pass Atlas's J
  scratch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_atlas_fixture as atfx
import test_torch_h1_fixture as h1fx
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.envs import standins
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from loco_mujoco_tpu_torch.ops import plan as tplan
from test_torch_fixture import _same
from test_torch_g1arms_plan import _record
from test_torch_h1_fixture import census

FIXTURES = {"h1arms": h1fx, "atlasarms": atfx}
# nv, bodies, limited hinges (= motors), integrator, (t1, t2, condim, k,
# pairs) of each group, slots, rows, J in the global scratch
CENSUS = {
    "h1arms": (25, 17, 19, 0, [(0, 5, 3, 4, 4), (0, 7, 3, 8, 21)], 40, 184,
               False),
    "atlasarms": (31, 25, 25, 1, [(0, 5, 3, 8, 14), (0, 6, 3, 8, 14)], 64,
                  288, True),
}
# the small variants: nv, (t1, t2, condim, k, pairs), slots, rows
CENSUS_SMALL = {
    "h1arms": (25, [(0, 5, 3, 2, 2), (0, 7, 3, 3, 14)], 17, 92),
    "atlasarms": (27, [(0, 5, 3, 3, 8), (0, 6, 3, 3, 10)], 24, 120),
}
ARMS = {"h1arms": "loco_mujoco_tpu.models.humanoids.unitree_h1",
        "atlasarms": "loco_mujoco_tpu.models.humanoids.atlas"}


def _jax_plan(fixture, monkeypatch):
    """The JAX package's own RowPlan of the committed full-width model in
    float32, from one collision pass at qpos0."""
    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin

    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    with jax.enable_x64(False):
        jm = fixture.jax_model(True, dtype=jnp.float32, arms=True)
        if jm.mesh_vert.shape[0]:
            monkeypatch.setenv("LMT_MESH_VCAP",
                               str(max(jm.mesh_vert.shape[1], 8)))
        jd = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
        return pc.get_plan(jm, jd.contact)


@pytest.mark.parametrize("name", list(CENSUS))
def test_arms_census_and_plans(name, monkeypatch):
    """The committed stand-in's census, and its plan: the JAX package's
    own (mega, plane-only, pyramidal) and the port's, equal field for
    field, at width 32."""
    import importlib

    nv, nb, nlim, integ, groups, ncon, nrows, _ = CENSUS[name]
    m = standins.load_standin(name, device="cpu")
    assert (m.nv, m.nbody, m.nu) == (nv, nb, nlim)
    assert int(m.jnt_limited.sum()) == nlim and m.nbody <= tplan.BODY_MAX
    assert set(importlib.import_module(ARMS[name]).ARMS) <= set(
        m.names["joint"])
    assert m.opt.cone == 0 and m.opt.integrator == integ
    assert census(m) == groups
    assert standins.standin_kind(m) == name[:-4]
    tp = m.plan
    assert tp.mega and tp.uniform and not tp.mega_ell and not tp.elliptic
    assert (tp.ncon, tp.nrows, tp.nvm) == (ncon, nrows, 32)
    assert tp.euler_dv == (integ == 0) and hm.ext_mode(tp) == 0
    assert tp.nrows <= tplan.ROWS_MAX and tp.ncon <= tplan.CON_MAX
    assert os.path.getsize(FIXTURES[name].ASSET_ARMS) < 512 * 1024
    jp = _jax_plan(FIXTURES[name], monkeypatch)
    assert jp is not None and jp.mega and not jp.mega_ell
    for field in ("elliptic", "mega_ell", "mega", "euler_dv", "smooth",
                  "uniform", "pack_w", "nfric", "nrows", "npad", "ncon",
                  "ne", "nfl", "nl", "rows_per"):
        got, ref = getattr(tp, field), getattr(jp, field)
        assert (list(got) if field == "rows_per" else got) == ref, field
    np.testing.assert_array_equal(tp.con_efcadr, jp.con_efcadr)


@pytest.mark.parametrize("name", list(CENSUS))
def test_committed_arms_npz_matches_generator(name, tmp_path):
    """Drift test: the committed model is what the generator makes now,
    leaf for leaf."""
    fx = FIXTURES[name]
    fresh = tmp_path / "fresh.npz"
    fx.write_full_width(fresh, arms=True)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(fx.ASSET_ARMS)
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k


@pytest.mark.parametrize("name", list(CENSUS))
def test_small_arms_variant_crosses_the_width(name):
    """The float32 mega tests' variants: nv past 24 on the plane-only
    plan at width 32, with fewer slots and rows."""
    nv, groups, ncon, nrows = CENSUS_SMALL[name]
    _, small = FIXTURES[name].torch_model(full=False, dtype=torch.float32,
                                          arms=True)
    assert small.nv == nv and census(small) == groups
    sp = small.plan
    assert sp.mega and not sp.mega_ell and sp.nvm == 32
    assert (sp.ncon, sp.nrows) == (ncon, nrows)


@pytest.mark.parametrize("name", list(CENSUS))
def test_arms_launch_places_j(name, monkeypatch):
    """H1 with its arms keeps J in shared memory (38,304 bytes per env, 6
    resident warps per SM); Atlas with its arms keeps it in the global
    scratch (J in shared memory would take 65,168 bytes and leave 3),
    E x nrows x NVJ floats, made once per env count."""
    m = standins.load_standin(name, device="cpu")
    launch = tplan.mega_launch(m.plan)
    c = tplan.mega_census(m.plan)
    j_global = CENSUS[name][-1]
    assert launch.j_global == j_global
    assert launch.resident_warps >= tplan.RESIDENT_FLOOR
    assert launch.extra["NVJ"] == m.nv | 1
    in_shared = launch.offset["ROW"] - launch.offset["J"]
    assert (in_shared < c["nrows"] * launch.extra["NVJ"]) == j_global
    J = launch.jrows(64, "cpu")
    if j_global:
        assert J.shape == (64, m.plan.nrows, m.nv) and J.dtype == torch.float32
        assert launch.jrows(64, "cpu") is J
        monkeypatch.setattr(tplan, "RESIDENT_FLOOR", 3)
        in_shared = tplan.MegaLaunch(c)
        assert not in_shared.j_global and in_shared.resident_warps == 3
    else:
        assert J is None and launch.resident_warps == 6


@pytest.mark.parametrize("name", list(CENSUS))
def test_arms_wrappers_load_the_wide_plane_only_instance(name, monkeypatch):
    """On a CUDA tensor the mega wrappers load the library compiled at 32
    and launch the plane-only instance (ext 0), with and without the
    damping rows (a non-null damping operand), passing Atlas's J scratch
    (the pointer after the last output) and no scratch for H1; the fused
    wrapper loads the wide library too."""
    libs = _record(monkeypatch)
    E = 5
    m = standins.load_standin(name, device="cpu")
    dyn = m.replace(plan=m.plan.dyn_damping())
    for model, damp in ((m, None), (dyn, m.dof_damping.expand(E, -1)
                                    .contiguous())):
        d = tio.make_data(model, E).replace(dof_damping=damp)
        hm.mega_forward(model, d)
        assert libs["mega"].defines == ("LMT_NVM=32",)
        args = libs["mega"].calls["lmt_mega_forward"]
        assert (args[9] is None) == (damp is None)  # the damping operand
        assert (args[24] is None) == (not CENSUS[name][-1])  # jrows
        assert args[28] == 0  # ext: the plane-only instance
        if hm.megastep_mode(model) is not None:  # not Euler with the rows
            hm.mega_step_n(model, d, 2)
            args = libs["mega"].calls["lmt_megastep"]
            assert (args[9] is None) == (damp is None)
            assert (args[15] is None) == (not CENSUS[name][-1])
        hf.fused_constraint(model, d)
        assert libs["fused"].defines == ("LMT_NVM=32",)
