"""The launch of the warp-per-env fused and Newton kernels, on the CPU.

`csrc/fused.cu` and `csrc/newton.cu` run one warp per env on the mega
kernels' warp core (`csrc/warp_core.cuh`), the env's state in the block's
dynamic shared memory, laid out from a census by `ops/plan.py`:
`FusedLaunch` (`fused_launch(plan)`) and `SolveLaunch`
(`solve_launch(nv, nrows, ne, nfl)`). Here, for every committed stand-in's
plan (the fused kernel of its staged path) and for the two configurations
without a plan that `chip_smoke.py` drives through the Newton kernel (the
torque humanoid with 34 plane-mesh slots, 456 rows at nv 19; G1 with its
arms and 20 plane-mesh slots, 455 rows at nv 29):

- the bytes per env, where the rows' J lives (shared memory, the fused
  kernel's global scratch, or the Newton operand itself), at least
  `RESIDENT_FLOOR` resident warps per SM, and regions that are 16-byte
  aligned, in order, disjoint and as large as what the kernels put there;
- a census that cannot fit raises, naming its regions;
- the wrappers pass the C prototypes of `csrc/fused.cu` and
  `csrc/newton.cu` (a recording stand-in for the compiled library): the
  launch's table, geometry, instance flags and J scratch;
- the Newton wrapper's CPU path and the fused kernel's plain version
  return what they returned before the kernels ran a warp per env (the
  values below were taken from the one-thread kernels' checkout on a
  seeded state: iterations and taken steps exact, qacc rel 1e-4).

No reference kernel is compiled here: every check is of plain PyTorch or
of the launch plan.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import constraint as con
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import hopper_newton as hn
from loco_mujoco_tpu_torch.ops import kernels, kinematics, solver
from loco_mujoco_tpu_torch.ops import plan as tplan

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "loco_mujoco_tpu_torch" / "csrc"
ASSETS = REPO / "loco_mujoco_tpu_torch" / "assets"
STANDINS = ("humanoid_torque_shape", "humanoid_muscle_shape",
            "unitree_a1_shape", "unitree_a1_position_shape",
            "unitree_h1_shape", "unitree_h1_arms_shape", "atlas_shape",
            "atlas_arms_shape", "unitree_g1_shape", "unitree_g1_arms_shape",
            "unitree_g1_kp_shape", "talos_shape")
# the configurations without a plan: (asset, change, nv, rows)
NO_PLAN = {"wide": ("humanoid_torque_shape", {"contact_k_plane": 34}, 19,
                    456),
           "g1arms": ("unitree_g1_arms_shape", {"contact_k_plane": 20}, 29,
                      455)}


def _model(asset, change=None):
    leaves, aux = io.read_model_npz(ASSETS / f"{asset}.npz")
    aux.update(change or {})
    return io.model_from_numpy(leaves, aux, device="cpu",
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in STANDINS}


def _regions_hold(launch, need):
    """Aligned, in order, disjoint and at least `need` floats each."""
    names = [n for n in tplan.SHM[1:16] if n != "MESH"]
    offs = [launch.offset[n] for n in names] + [launch.env_floats]
    for i, n in enumerate(names):
        assert offs[i] % 4 == 0, n
        assert offs[i + 1] - offs[i] >= need.get(n, 0), n
    assert launch.shared_bytes == launch.envs_per_block * 4 \
        * launch.env_floats <= tplan.SHM_PER_BLOCK
    assert launch.resident_warps >= tplan.RESIDENT_FLOOR
    blocks = launch.resident_warps // launch.envs_per_block
    assert blocks * (launch.shared_bytes + tplan.SHM_RESERVED) \
        <= tplan.SHM_PER_SM
    assert launch.table()[0] == launch.env_floats
    assert len(launch.table()) == len(tplan.SHM)


@pytest.mark.parametrize("name", STANDINS)
def test_fused_census_fits_and_layout_holds(models, name):
    """Every stand-in's fused launch: J in shared memory where that leaves
    RESIDENT_FLOOR warps, else in the global scratch (the shared J region
    then the smooth stage's scratch alone), the pack's slots, the double
    solve's state for an elliptic plan."""
    plan = models[name].plan
    launch = tplan.fused_launch(plan)
    nv, rows, ell = plan.nv, plan.nrows, plan.elliptic
    nvj = launch.extra["NVJ"]
    assert nvj == nv | 1 and launch.extra["SLOTW"] == plan.pack_w
    assert launch.extra["RS"] % 4 == 0 and launch.extra["RS"] >= rows
    need = {"VEC": tplan.NVEC * nv, "CDOF": 12 * nv, "JNT": 6 * plan.njnt,
            "BODY": tplan.BODY_W * plan.nbody, "M": nv * nv,
            "L": 2 * (nv * nv + 5 * nv) if ell else nv * nv + nv,
            "J": 12 * nv if launch.j_global else rows * nvj,
            "ROW": (tplan.ROW_ARRAYS_ELL if ell else tplan.ROW_ARRAYS)
            * launch.extra["RS"],
            "R": plan.ne + plan.nfl, "FL": plan.nfl, "MU": plan.ncon_ell,
            "SLOT": plan.ncon * plan.pack_w,
            "MISC": tplan.MISC_W + hn.row_words(rows)}
    _regions_hold(launch, need)
    shared_j = launch.offset["ROW"] - launch.offset["J"]
    if launch.j_global:  # J would have left too few warps in shared memory
        assert shared_j < rows * nvj
        assert tplan.FusedLaunch(dict(tplan.fused_census(plan),
                                      nrows=0)).resident_warps \
            >= tplan.RESIDENT_FLOOR
        J = launch.jrows(8, "cpu")
        assert J.shape == (8, rows, nvj) and launch.jrows(8, "cpu") is J
    else:
        assert launch.jrows(8, "cpu") is None
    assert tplan.fused_launch(plan.dyn_damping()).table() == launch.table()


def test_fused_census_places_j():
    """The committed stand-ins' J: A1 (elliptic, both modes), G1 with its
    arms and Atlas with its arms in the global scratch; every other in
    shared memory. Bytes per env stay within 16-48 KB."""
    got = {}
    for name in STANDINS:
        launch = tplan.fused_launch(_model(name).plan)
        got[name] = launch.j_global
        assert 16e3 <= 4 * launch.env_floats <= 48e3, name
    assert {n for n, g in got.items() if g} == {
        "unitree_a1_shape", "unitree_a1_position_shape",
        "unitree_g1_arms_shape", "atlas_arms_shape"}


@pytest.mark.parametrize("name", list(NO_PLAN))
def test_solve_census_fits_and_layout_holds(name):
    """The Newton kernel's launch at the no-plan configurations' rows:
    no J, FK, collision, mesh or muscle region (J is the operand, row
    stride nv), the row arrays and lists, M, H and the gradient, the
    vectors and the decision words; 16-26 KB per env."""
    asset, change, nv, rows = NO_PLAN[name]
    m = _model(asset, change)
    assert m.plan is None and m.nv == nv
    d = fwd.fwd_position(m, io.make_data(m, 2), plain=True)
    efc = con.make_constraint(m, d)
    assert efc.J.shape[1] == rows
    ne, nfl = hn.row_class_counts(efc.is_bilateral, efc.is_fl)
    launch = hn.solve_launch(nv, rows, ne, nfl)
    assert launch is hn.solve_launch(nv, rows, ne, nfl)  # made once
    assert launch.extra["NVJ"] == nv and not launch.j_global
    rs = launch.extra["RS"]
    need = {"VEC": tplan.NVEC * nv, "M": nv * nv, "L": nv * nv + nv,
            "ROW": tplan.ROW_ARRAYS * rs, "R": ne + nfl, "FL": nfl,
            "MISC": tplan.MISC_W + hn.row_words(rows)}
    _regions_hold(launch, need)
    names = [n for n in tplan.SHM[1:16] if n != "MESH"]
    ends = [launch.offset[n] for n in names[1:]] + [launch.env_floats]
    for region in ("CDOF", "JNT", "BODY", "J", "SLOT", "MUS"):
        assert ends[names.index(region)] == launch.offset[region], region
    assert 16e3 <= 4 * launch.env_floats <= 26e3


def test_census_that_cannot_fit_raises(models):
    """Past shared memory even with J in the global scratch (the fused
    kernel), or at all (the Newton kernel), the census raises and names
    its regions; past the widest width, the nv."""
    c = tplan.fused_census(models["unitree_a1_shape"].plan)
    with pytest.raises(ValueError, match=r"SLOT \d+.*resident warps"):
        tplan.FusedLaunch(dict(c, ncon=2000))
    with pytest.raises(ValueError, match="nv"):
        tplan.FusedLaunch(dict(c, nv=tplan.NV_MAX + 1))
    with pytest.raises(ValueError,
                       match=r"Newton kernel: .*ROW \d+.*resident warps"):
        tplan.SolveLaunch(32, 12000, 0, 0)
    with pytest.raises(ValueError, match="nv"):
        tplan.SolveLaunch(tplan.NV_MAX + 1, 8, 0, 0)


def _prototype(src, fn):
    """The ctypes types of an extern "C" launcher's parameters."""
    args = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src).group(1)
    kinds = {"void*": kernels.PTR, "int": kernels.INT,
             "float": kernels.FLOAT, "int*": kernels.PTR}
    return [kinds[a.strip().rsplit(" ", 1)[0].replace("const ", "")
                  .replace(" ", "")] for a in args.replace("\n", " ")
            .split(",")]


@pytest.mark.parametrize("mod, source", [(hf, "fused.cu"),
                                         (hn, "newton.cu")])
def test_signatures_match_the_kernel_source(mod, source):
    src = (CSRC / source).read_text()
    for fn, types in mod._SIGNATURES.items():
        assert _prototype(src, fn) == types, fn


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


@pytest.fixture
def recorded(monkeypatch):
    libs = {}

    def library(name, signatures, defines=()):
        libs[name] = _Recorder(defines)
        return libs[name]

    monkeypatch.setattr(kernels, "library", library)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    return libs


@pytest.mark.parametrize("name, dr", [("humanoid_torque_shape", False),
                                      ("unitree_a1_shape", True),
                                      ("unitree_g1_arms_shape", False)])
def test_fused_wrapper_passes_the_launch(models, recorded, name, dr):
    """The fused wrapper's launch: the census table (`shm`), the J
    scratch where the launch keeps J global, the damping-rows and
    elliptic instance flags, shared floats and envs per block, the
    library of the plan's width; an elliptic plan at width 32 raises."""
    m = models[name]
    E = 3
    d = io.make_data(m, E)
    if dr:
        m = m.replace(plan=m.plan.dyn_damping())
        d = d.replace(dof_damping=m.dof_damping.expand(E, -1).contiguous())
    plan = m.plan
    launch = tplan.fused_launch(plan)
    hf.fused_constraint(m, d)
    lib = recorded["fused"]
    assert lib.defines == kernels.width_defines(plan.nvm)
    args, types = lib.calls["lmt_fused"], hf._SIGNATURES["lmt_fused"]
    assert len(args) == len(types)
    assert args[2] == launch.tensor("cpu").data_ptr()
    assert launch.tensor("cpu").tolist() == launch.table()
    jr = launch.jrows(E, "cpu")
    assert args[14] == (None if jr is None else jr.data_ptr())
    ints = [a for a, t in zip(args, types) if t is kernels.INT]
    assert ints == [E, hf.vec(m, d).shape[1], int(dr), int(plan.elliptic),
                    plan.iterations, plan.ls_iterations, launch.env_floats,
                    launch.envs_per_block]
    if plan.elliptic:
        wide = plan.with_budget(plan.iterations, plan.ls_iterations)
        wide.nvm = kernels.NV_WIDTHS[-1]
        with pytest.raises(NotImplementedError, match="elliptic"):
            hf.library(wide)


def test_newton_wrapper_passes_the_launch(recorded):
    """The Newton wrapper launches once on the operands as they come
    (no relayout: their own pointers), with `solve_launch`'s table and
    geometry, from the library of the narrowest width that holds nv."""
    E, nefc, ne, nfl = 3, 40, 2, 3
    for nv, width in ((19, 24), (29, 32)):
        kernels.LAUNCHES.clear()
        z = [torch.zeros(s) for s in ((E, nefc, nv), (E, nv, nv), (E, nefc),
                                      (E, nefc), (E, nefc), (E, nefc),
                                      (E, nefc), (E, nv), (E, nv))]
        rec = {}
        x, f, it, tk = hn.solve(*z, ne=ne, nfl=nfl, iterations=8,
                                ls_iterations=6, scale=1.0, tol=1e-6,
                                record=rec)
        assert dict(kernels.LAUNCHES) == {"newton": 1}
        lib = recorded["newton"]
        assert lib.defines == kernels.width_defines(width)
        args = lib.calls["lmt_newton_solve"]
        assert list(args[:9]) == [t.data_ptr() for t in z]
        assert list(args[9:15]) == [t.data_ptr() for t in (
            x, f, it, tk, rec["ls"], rec["rows"])]
        launch = hn.solve_launch(nv, nefc, ne, nfl)
        assert args[15] == launch.tensor("cpu").data_ptr()
        assert list(args[16:25]) == [E, nv, nefc, ne, nfl, 8, 6,
                                     launch.env_floats,
                                     launch.envs_per_block]
        assert rec["rows"].shape == (E, 8, hn.row_words(nefc))
        assert rec["ls"].shape == (E, hn.LS_WORDS)


def _state(m, E=2, seed=0):
    rng = np.random.default_rng(seed)
    qpos = m.qpos0.numpy()[None] + rng.normal(scale=0.02, size=(E, m.nq))
    z = next(n for n in m.names["joint"] if n.endswith("tz") or n == "root_z")
    qpos[:, int(m.jnt_qposadr[m.names["joint"][z]])] -= 0.015
    qvel = rng.normal(scale=0.3, size=(E, m.nv))
    return io.make_data(m, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32),
        qvel=torch.as_tensor(qvel, dtype=torch.float32))


# the one-thread kernels' checkout on _state(): env 0's qacc, the second
# output's absolute sum (the Newton forces, the fused qfrc_constraint),
# iterations and taken bits of both envs
BEFORE = {
    "newton": ([-0.242038, 3.00779, 4.40457, 23.2837, -1.82067, 71.9069,
                -98.779, 5.31629, -32.183, -126.086, -75.4618, 1.58722,
                -131.834, 133.384, -59.3339, -35.2562, 11.1918, -12.4873,
                -65.7838], 3603.703857421875, [8, 6],
               [-2147483521, -2147483617]),
    "humanoid_torque_shape": (
        [-0.242031, 3.00777, 4.40448, 23.283, -1.82066, 71.9068, -98.7785,
         5.31613, -32.1827, -126.083, -75.4561, 1.58747, -131.835, 133.387,
         -59.3333, -35.2568, 11.1919, -12.4872, -65.784], 7325.26806640625,
        [8, 5], [-2147483521, -2147483633]),
    "unitree_a1_shape": (
        [-0.277306, -0.00204033, -10.1036, -1.68055, 3.23202, -0.298633,
         -58.0947, -21.145, -7.42642, 7.90175, -9.95953, -58.1653, -16.7226,
         -16.8662, -10.3906, 20.852, -13.8578, -22.5093], 478.2365417480469,
        [7, 7], [-2147483585, -2147483585]),
    # the elliptic plan's CPU path, whose solve runs in float64 as the
    # kernel's does (`solve64`): this tree's values
    "unitree_a1_shape/solve64": (
        [-0.27731, -0.00204025, -10.1036, -1.68082, 3.23191, -0.298657,
         -58.0943, -21.145, -7.42616, 7.90197, -9.95947, -58.1653, -16.7224,
         -16.8663, -10.3901, 20.8536, -13.8579, -22.5081],
        478.23565673828125, [7, 7], [-2147483521, -2147483521]),
}


def _same_as_before(key, qacc, second, iters, taken):
    q0, s, it, tk = BEFORE[key]
    assert iters.tolist() == it and taken.tolist() == tk
    torch.testing.assert_close(qacc[0], torch.tensor(q0), rtol=1e-4,
                               atol=1e-4 * max(map(abs, q0)))
    assert abs(float(second.abs().sum()) - s) <= 1e-4 * s


def test_newton_cpu_path_unchanged():
    """`hopper_newton.solve` on CPU tensors is `newton_plain` (its record
    too), and returns what it returned before."""
    m = _model(*NO_PLAN["wide"][:2])
    d = fwd.fwd_position(m, _state(m), plain=True)
    d = fwd.fwd_acceleration(m, fwd.fwd_actuation(m, fwd.fwd_velocity(m,
                                                                      d)))
    operands, options = solver.newton_inputs(m, d,
                                             con.make_constraint(m, d))
    rec, want = {}, {}
    got = hn.solve(*operands, **options, record=rec)
    ref = hn.newton_plain(*operands, **options, record=want)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(rec["rows"], want["rows"])
    _same_as_before("newton", *got)


@pytest.mark.parametrize("name", ["humanoid_torque_shape",
                                  "unitree_a1_shape"])
def test_fused_plain_unchanged(models, name):
    """`fused_constraint` on CPU tensors is its plain version (for the
    elliptic layout the float64 solve, as the kernel's), and the plain
    version returns what it returned before (in float32 unless asked for
    float64)."""
    m = models[name]
    d = coll.collision(m, kinematics.kinematics(m, _state(m)))
    got = hf.fused_constraint(m, d)
    ref = hf.fused_constraint_plain(m, d, solve64=m.plan.elliptic)
    for f in ("qacc", "qfrc_constraint", "solver_niter", "solver_rows"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    key = name + "/solve64" if m.plan.elliptic else name
    _same_as_before(key, got.qacc, got.qfrc_constraint, got.solver_niter,
                    got.solver_taken)
    f32 = hf.fused_constraint_plain(m, d)
    _same_as_before(name, f32.qacc, f32.qfrc_constraint, f32.solver_niter,
                    f32.solver_taken)
