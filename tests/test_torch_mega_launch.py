"""The launch of the warp-per-env mega kernels, on the CPU.

`csrc/mega.cu` runs one warp per env with the env's state in the block's
dynamic shared memory, laid out per env from the model's census by
`ops/plan.py`'s `MegaLaunch` (the table I_SHM of the packed plan). Here,
for the configurations of `chip_smoke.py`'s main path (the torque
humanoid with RK4 and with Euler, the muscle humanoid, A1, the H1- and
Atlas-shaped bipeds with their plane-cylinder groups, and the G1-shaped
biped on the extended collision with pyramidal rows):

- the shared bytes per env and the envs per block fit a Hopper block's
  227 KB, and leave at least `RESIDENT_FLOOR` (4) resident warps per SM;
  every region of the layout is 16-byte aligned, disjoint and as large as
  what the kernels put there, and the packed I_SHM table is the layout's;
- on these configurations the kernels take no global scratch (J stays in
  shared memory; the scratch of G1 with its arms, at the second compiled
  width, is tests/test_torch_g1arms_plan.py's): every operand the
  wrappers pass
  (`hopper_mega.mega_forward`, `mega_step_n`, with a recording stand-in
  for the compiled library) matches the C prototypes in `csrc/mega.cu`
  and `hopper_mega._SIGNATURES`, with the decision record's shape from
  `decision_width`;
- a census past the limits (too many rows for four warps per SM, nv past
  the compiled width) raises instead of shrinking;
- the C enums the layout mirrors (`Shm`, `Vec`, `BodyF`, `RowA`,
  `SlotF`, `kSegW`, `kMaxEnvsPerBlock`; csrc/warp_core.cuh and
  csrc/mega.cu) hold the Python widths.
"""

import re
from pathlib import Path

import pytest
import torch

from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from loco_mujoco_tpu_torch.ops import hopper_newton as hn
from loco_mujoco_tpu_torch.ops import kernels
from loco_mujoco_tpu_torch.ops import plan as tplan

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "loco_mujoco_tpu_torch" / "assets"
# the kernels' source and the warp core it includes (the enums)
SRC = "".join((REPO / "loco_mujoco_tpu_torch" / "csrc" / f).read_text()
              for f in ("mega.cu", "warp_core.cuh"))
CONFIGS = ("rk4", "euler", "muscle", "a1", "h1", "atlas", "g1")
ASSET_OF = {"muscle": "humanoid_muscle_shape", "a1": "unitree_a1_shape",
            "h1": "unitree_h1_shape", "atlas": "atlas_shape",
            "g1": "unitree_g1_shape"}


def _model(name):
    if name in ("rk4", "euler"):
        leaves, aux = io.read_model_npz(ASSETS / "humanoid_torque_shape.npz")
        if name == "euler":
            aux["opt.integrator"] = 0
        return io.model_from_numpy(leaves, aux, device="cpu",
                                   dtype=torch.float32)
    return io.load_model_npz(ASSETS / f"{ASSET_OF[name]}.npz", device="cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_launch_fits_and_layout_holds(name):
    plan = _model(name).plan
    assert plan.mega
    launch = tplan.mega_launch(plan)
    env_bytes = 4 * launch.env_floats
    assert launch.shared_bytes == launch.envs_per_block * env_bytes
    assert launch.shared_bytes <= tplan.SHM_PER_BLOCK
    assert 1 <= launch.envs_per_block <= tplan.ENVS_PER_BLOCK_MAX
    assert launch.resident_warps >= tplan.RESIDENT_FLOOR
    blocks = launch.resident_warps // launch.envs_per_block
    assert blocks * (launch.shared_bytes + tplan.SHM_RESERVED) \
        <= tplan.SHM_PER_SM
    # regions: aligned, in order, disjoint, large enough
    c = tplan.mega_census(plan)
    ell = plan.mega_ell and plan.elliptic  # the double solve's state
    nvj = launch.extra["NVJ"]
    assert nvj % 2 == 1 and nvj >= plan.nv
    assert launch.extra["RS"] % 4 == 0 and launch.extra["RS"] >= plan.nrows
    need = {"VEC": tplan.NVEC * plan.nv, "J": plan.nrows * nvj,
            "M": plan.nv ** 2,
            "L": (2 * (plan.nv ** 2 + 5 * plan.nv) if ell
                  else plan.nv ** 2 + plan.nv),
            "BODY": tplan.BODY_W * plan.nbody,
            "SLOT": plan.ncon * launch.extra["SLOTW"],
            "ROW": (tplan.ROW_ARRAYS_ELL if ell
                    else tplan.ROW_ARRAYS) * launch.extra["RS"],
            "MU": plan.ncon_ell, "FL": plan.nfl}
    assert launch.extra["SLOTW"] == (tplan.SLOT_W_EXT if plan.mega_ell
                                     else tplan.SLOT_W)
    # the collision's scratch lives in the J region (MESH)
    assert launch.offset["MESH"] == launch.offset["J"]
    need["J"] = max(need["J"], 3 * max(c["pairs"]) + 2 * max(c["ks"]))
    if plan.mp is not None:
        need["J"] = max(need["J"], tplan.SEG_W * len(plan.mp.i_seg))
        need["MUS"] = 2 * plan.na + plan.mp.nmus + 6 * plan.nbody
    names = [n for n in tplan.SHM[1:16] if n != "MESH"]
    offs = [launch.offset[n] for n in names] + [launch.env_floats]
    for i, n in enumerate(names):
        assert offs[i] % 4 == 0, n
        assert offs[i + 1] - offs[i] >= need.get(n, 1), n
    # the packed plan carries the layout
    ints, _ = plan.pack()
    at = int(ints[tplan.H["I_SHM"]])
    assert list(ints[at:at + len(tplan.SHM)]) == launch.table()


def test_census_past_the_limits_raises():
    c = tplan.mega_census(_model("a1").plan)
    tplan.MegaLaunch(c)  # fits
    with pytest.raises(ValueError, match="resident warps"):
        tplan.MegaLaunch(dict(c, nrows=2 * c["nrows"]))
    with pytest.raises(ValueError, match="nv"):
        tplan.MegaLaunch(dict(c, nv=tplan.NV_MAX + 1))
    small = tplan.MegaLaunch(dict(c, nrows=8, ncon=2, ncon_ell=2, nbody=2,
                                  njnt=2, nv=2, pairs=[2], ks=[1]))
    assert small.resident_warps == tplan.WARPS_PER_SM
    assert small.envs_per_block > 1  # past 32 blocks per SM


def _enum(name):
    body = re.search(r"enum " + name + r" \{([^}]*)\}", SRC).group(1)
    return [p.strip() for p in body.replace("\n", " ").split(",")
            if p.strip()]


def test_kernel_enums_hold_the_python_widths():
    assert _enum("Shm") == ["SH_" + n for n in tplan.SHM]
    vec = _enum("Vec")
    assert vec[-1] == "NVEC" and len(vec) - 1 == tplan.NVEC
    body = dict(p.split(" = ") for p in _enum("BodyF"))
    assert int(body["BW"]) == tplan.BODY_W
    assert max(int(v) for k, v in body.items() if k != "BW") + 6 \
        <= tplan.BODY_W
    rowa = _enum("RowA")  # the three 16-bit lists take two arrays
    i = rowa.index("R_LISTS")
    assert rowa[i + 1] == "R_CLS = R_LISTS + 2"
    assert i + 2 == tplan.ROW_ARRAYS
    assert i + 2 + len(rowa) - (i + 1) == tplan.ROW_ARRAYS_ELL
    slot = dict(p.split(" = ") for p in _enum("SlotF"))
    assert int(slot["S_GID"]) < tplan.SLOT_W
    assert int(slot["S_FRAME"]) + 9 <= tplan.SLOT_W_EXT
    assert f"kSegW = {tplan.SEG_W};" in SRC
    assert f"kMaxEnvsPerBlock = {tplan.ENVS_PER_BLOCK_MAX};" in SRC


def _prototype(fn):
    """The ctypes types of an extern "C" launcher's parameters."""
    args = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", SRC).group(1)
    kinds = {"void*": kernels.PTR, "int": kernels.INT,
             "float": kernels.FLOAT, "int*": kernels.PTR}
    out = []
    for a in args.replace("\n", " ").split(","):
        t = a.strip().rsplit(" ", 1)[0].replace("const ", "").replace(" ", "")
        out.append(kinds[t])
    return out


def test_signatures_match_the_kernel_source():
    for fn, types in hm._SIGNATURES.items():
        assert _prototype(fn) == types, fn


class _Recorder:
    """Stands in for the compiled library: records each launcher's
    arguments and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, fn):
        def call(*args):
            self.calls[fn] = args
            return 0
        return call


@pytest.mark.parametrize("name", ["euler", "a1", "h1", "atlas", "g1"])
def test_wrappers_pass_the_prototypes(name, monkeypatch):
    """The wrappers' operands, launch and outputs against the prototypes:
    no scratch, the launch plan's shared floats and envs per block, the
    kernels' instance (`ext`: 0 plane-only, 1 extended elliptic, 2
    extended pyramidal), the row record (E, iterations, row words) and the
    megastep's decisions (E, F n, decision_width)."""
    m = _model(name)
    launch = tplan.mega_launch(m.plan)
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda *a, **k: rec)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    n, E = 3, 5
    d = io.make_data(m, E)
    out = hm.mega_forward(m, d)
    dec = torch.zeros((E, hm.forwards_per_step(m) * n, hm.decision_width(m)),
                      dtype=torch.int32)
    hm.mega_step_n(m, d, n, decisions=dec)
    for fn in ("lmt_mega_forward", "lmt_megastep"):
        args, types = rec.calls[fn], hm._SIGNATURES[fn]
        assert len(args) == len(types), fn
        for a, t in zip(args, types):
            if t is kernels.PTR:
                assert a is None or isinstance(a, int), fn
            else:
                assert isinstance(a, int if t is kernels.INT else float), fn
        ints = [a for a, t in zip(args, types) if t is kernels.INT]
        assert ints[-3:] == [{"a1": 1, "g1": 2}.get(name, 0),
                             launch.env_floats, launch.envs_per_block], fn
    rw = hn.row_words(m.plan.nrows)
    assert out.solver_rows.shape == (E, m.plan.iterations, rw)
    assert hm.decision_width(m) == 2 + hn.LS_WORDS + m.plan.iterations * rw
    with pytest.raises(ValueError, match="decisions"):
        hm.mega_step_n(m, d, n, decisions=dec[:, :1])


@pytest.mark.parametrize("name", ["rk4", "a1"])
def test_wrappers_pass_the_damping_rows(name, monkeypatch):
    """Both mega launchers and the fused one take each env's damping where
    the plan has the damping rows (`dyn_damping`): the mega kernels as the
    operand after the warm start, the fused kernel at the end of its smooth
    vector; without the rows the mega operand is null and the vector is
    as it was. The launch (shared floats, envs per block) is the same."""
    m = _model(name)
    dyn = m.replace(plan=m.plan.dyn_damping())
    assert (tplan.mega_launch(dyn.plan).table()
            == tplan.mega_launch(m.plan).table())
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda *a, **k: rec)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    E = 5
    d = io.make_data(m, E)
    rows = m.dof_damping.expand(E, -1).contiguous()
    for model, data, want in ((m, d, None), (dyn, d.replace(dof_damping=rows),
                                             rows)):
        rec.calls.clear()
        hm.mega_forward(model, data)
        stepped = hm.mega_step_n(model, data, 2)
        # Euler with per-env damping has no megastep (no euler_dv)
        assert (stepped is None) == (want is not None and name == "a1")
        for fn in rec.calls:
            got = rec.calls[fn][2 + 7]  # ints, flts, 7 state operands
            assert (got is None) == (want is None), fn
            if want is not None:
                assert got == want.data_ptr(), fn
    smooth = hf.smooth_vec(d)
    assert hf.vec(m, d).shape == smooth.shape
    torch.testing.assert_close(
        hf.vec(dyn, d.replace(dof_damping=rows)),
        torch.cat([smooth, rows], dim=1), rtol=0, atol=0)


def test_mega_forward_points_operand(monkeypatch):
    """`points=True` passes the slots' point output after act_dot and
    returns it as `contact.pos` (E, ncon, 3); without it the operand is
    null (the main path's launches)."""
    m = _model("euler")
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda *a, **k: rec)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    E = 5
    d = io.make_data(m, E)
    at = 2 + 8 + 13  # ints, flts, 8 operands, 13 outputs before it
    hm.mega_forward(m, d)
    assert rec.calls["lmt_mega_forward"][at] is None
    out = hm.mega_forward(m, d, points=True)
    assert rec.calls["lmt_mega_forward"][at] is not None
    assert out.contact.pos.shape == (E, m.ncon, 3)
