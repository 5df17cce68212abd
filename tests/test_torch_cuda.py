"""The port's Hopper kernels against their plain versions, on the card.

Needs an NVIDIA GPU (marker `cuda`; skipped without one). It imports no
JAX, so it runs on a machine without it, skipping this directory's
conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Inputs are the committed full-width model at 256 envs, dropped onto the
floor. Tolerances are chip_smoke.py's: relayouts bit-exact; the
plane-mesh kernel's active slots, geom ids and statics exact, dist atol
1e-6, pos atol 1e-5, frame atol 1e-6, every near pair's key atol 1e-6
(`_mesh_slots_rule`, also on G1, `wide`'s k 34, Talos's k = P and a
ragged and a single env); Newton qacc and forces rel 5e-4 on every env, the plain version
replaying the kernel's discrete decisions (warm start, iteration count,
steps taken, the line search's signs and each step's Hessian decision of
every row). The fused constraint kernel, on the four configurations of
`test_torch_fixture.CONFIGS`, is held to its plain version with the
kernel's decisions replayed: qacc, qfrc_constraint, efc_force_contact and
euler_dv rel 5e-4 of their largest value on every env. The mega forward
and the megastep (one control step of 10 RK4 or Euler substeps) are held
to their plain versions replaying the kernels' decisions: qacc,
qfrc_constraint and efc_force_contact (forward) and qpos, qvel (megastep)
rel 5e-4 of their largest value, active slots and their geom ids exact and
depths atol 1e-5, on every env whose active contact set matches; an env
whose set differs must have a slot within 1e-5 of its margin (a float32
tie), and at most 0.5% of the envs may. The committed muscle model
(`humanoid_muscle_shape.npz`, muscle ctrls in [0, 1], activations from
`test_torch_fixture.seeded_act`) is held the same way: its mega forward
with act_dot, its Euler megastep with act, and its staged non-smooth fused
stage. The committed A1-shaped model (`unitree_a1_shape.npz`, elliptic
cones, all classic analytic pair kinds, Euler) is held the same way on
`test_torch_a1_fixture.a1_states`' states: its mega forward and megastep
with the extended collision (geom1 and geom2 exact on active slots), its
staged fused elliptic layout, and the refusal of its rows by the
standalone Newton kernel. The committed H1- and Atlas-shaped models
(`unitree_h1_shape.npz`, Euler, a plane-cylinder group with its pairs in
order beside a plane-mesh group; `atlas_shape.npz`, RK4, top-K
plane-cylinder and plane-box groups) are held the same way on
`test_torch_h1_fixture.biped_states`' states, whose env 0 stands with its
heel discs upright on the floor and env 1 with them on their rim: both
mega kernels at 4096 envs, at a ragged count and at one env, the upright
and the rim envs held with no tie excuse. The committed G1-shaped model
(`unitree_g1_shape.npz`, Euler, the extended collision with pyramidal rows,
a plane-mesh group among sphere, capsule and self groups) is held the same
way on `test_torch_g1_fixture.g1_states`' states: its mega forward (geom1
and geom2 exact on active slots) and megastep at 4096 envs, its staged
fused kernel (the 26-float pack) on every env, and its env's `step_batch`.
The committed A1 position stand-in (`unitree_a1_position_shape.npz`:
position servos, fixed gain and affine bias in the smooth stage) is held
the same way on `a1_states`' states with targets in the joint ranges: its
mega forward and megastep at 4096 envs, its staged fused kernel and its
env's `step_batch`; the torque humanoid with affine motors (gain and bias)
on its plane-only megastep. The committed stand-in of G1 with its arms
(`unitree_g1_arms_shape.npz`: nv 29, the libraries compiled at the second
width, 32, the rows' J in the launch's global scratch) is held the same
way on `g1_states`' states: its mega forward and megastep at 4096 envs,
its staged fused kernel, the Newton kernel at width 32 on its staged rows,
its env's `step_batch`, and the refusal of an instance the wide library
does not hold.

Every random input comes from numpy's seeded generator or from a CUDA
generator seeded with the draw's number (`_qvel`, the draws of
`tools/fused_determinism.py`, whose draw 14 and draw 27 held the two
envs the replay missed before it carried the rows' Hessian decisions).
The mega forward and the megastep, the fused kernel and the Newton kernel
(all four a warp per env) are also held at a ragged env count (4093, not a
multiple of a block's envs) and at one env, and checked bit-deterministic
from run to run; every instance of the fused and Newton kernels leaves at
least `plan.RESIDENT_FLOOR` warps resident per SM. An elliptic plan's fused
kernel solves in float64, and so does its plain version here. Model leaves
that differ per env: the plane-mesh kernel with the four 4-ages scalings'
hull tables, each env reading its variant's (held as above; every env on
the first table gives the one-table launch bit for bit), and the fused
kernel's non-smooth layout on a randomized env's per-env masses, full
inertia and armature, held on every env.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.envs import standins
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import constraint as con
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_collision as hc
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import hopper_layout as lay
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from loco_mujoco_tpu_torch.ops import hopper_newton as hn
from loco_mujoco_tpu_torch.ops import kernels, kinematics, solver
from loco_mujoco_tpu_torch.ops.plan import (RESIDENT_FLOOR, fused_launch,
                                            mega_launch)
from test_torch_fixture import CONFIGS, hold_ctrl, seeded_act

pytestmark = pytest.mark.cuda

ASSET = (Path(__file__).resolve().parent.parent / "loco_mujoco_tpu_torch"
         / "assets" / "humanoid_torque_shape.npz")
MUSCLE_ASSET = ASSET.with_name("humanoid_muscle_shape.npz")
E = 256
DRAWS = (0, 14, 27)  # tools/fused_determinism.py's draws of qvel


def _qvel(n, nv, draw):
    """tools/fused_determinism.py's qvel of `draw`: 0.1 x a normal draw
    from a CUDA generator seeded with the draw's number."""
    g = torch.Generator(device="cuda").manual_seed(draw)
    return 0.1 * torch.randn(n, nv, device="cuda", generator=g)


def _model(change=None, asset=ASSET):
    """A committed model on the card with a configuration change: a
    static entry, or the first column of the last pair's leaf row."""
    leaves, aux = io.read_model_npz(asset)
    for k, v in (change or {}).items():
        if k.startswith("leaf:"):
            leaves[k[5:]] = np.array(leaves[k[5:]])
            leaves[k[5:]][-1, 0] = v
        else:
            aux[k] = v
    return io.model_from_numpy(leaves, aux, device="cuda")


def _dropped(model, n=E):
    """n envs at qpos0 + noise, dropped 15 mm onto the floor."""
    rng = np.random.default_rng(0)
    qpos = model.qpos0.cpu().numpy()[None] + rng.normal(scale=0.02,
                                                        size=(n, model.nq))
    qpos[:, int(model.jnt_qposadr[model.names["joint"]["root_z"]])] -= 0.015
    return io.make_data(model, n).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32, device="cuda"))


@pytest.fixture(scope="module")
def state():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _model()
    return model, fwd.fwd_position(model, _dropped(model), plain=True)


def test_relayouts_bit_exact(state):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(E, 37, device="cuda", generator=g)
    assert torch.equal(lay.to_grouped(x), x.t().contiguous())
    assert torch.equal(lay.from_grouped(x.t().contiguous()), x)
    y = torch.randn(E, 5, 9, device="cuda", generator=g)
    assert torch.equal(lay.moveaxis0_last(y), torch.movedim(y, 0, -1))
    assert torch.equal(lay.moveaxis_last0(lay.moveaxis0_last(y)), y)


# (R, C) of a 16-array list: square and ragged tiles, C % 4 != 0 (scalar
# loads), R % 4 != 0 (scalar stores), R < 32 and C < 32 (the packed
# strips), one element, and the call sites' widths at 4096 envs
MIXED = [(4096, 225), (4096, 75), (1, 1), (19, 4096), (4096, 19), (24, 4096),
         (4096, 2), (33, 97), (97, 33), (5, 3), (3, 70), (70, 3), (64, 64),
         (456, 4096), (31, 130), (4096, 361)]


def test_grouped_relayout_bit_exact(state):
    """The grouped kernel against its plain version: a 16-array list of
    mixed shapes in one launch, a list of one, and operands whose base is
    4 bytes off a 16-byte boundary (the scalar path throughout)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(s, device="cuda", generator=g) for s in MIXED]
    kernels.LAUNCHES.clear()
    for role, fn, plain in (
            ("to_grouped", lay.to_grouped_many, lay.transpose_plain),
            ("moveaxis0_last", lay.moveaxis0_last_many,
             lay.moveaxis0_last_plain)):
        ys = fn(*xs)
        torch.cuda.synchronize()
        for x, y in zip(xs, ys):
            assert torch.equal(y, plain(x)), (role, tuple(x.shape))
    (y,) = lay.from_grouped_many(xs[3])
    assert torch.equal(y, xs[3].t())
    off = [torch.randn(s[0] * s[1] + 1, device="cuda", generator=g)[1:]
           .view(s) for s in MIXED[:6]]
    assert all(x.data_ptr() % 16 == 4 for x in off)
    for x, y in zip(off, lay.moveaxis_last0_many(*off)):
        assert torch.equal(y, x.t())
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"to_grouped": 1, "moveaxis0_last": 1,
                                      "from_grouped": 1, "moveaxis_last0": 1}


def test_grouped_relayout_raises(state):
    """Past 16 arrays, a non-contiguous or a float64 operand, or a CPU one
    beside CUDA ones, the list form raises and launches nothing."""
    x = torch.zeros(64, 8, device="cuda")
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match="at most 16"):
        lay.moveaxis0_last_many(*[x] * 17)
    with pytest.raises(ValueError, match="contiguous"):
        lay.moveaxis0_last_many(x, torch.zeros(8, 64, device="cuda").t())
    with pytest.raises(TypeError, match="float32"):
        lay.to_grouped_many(x, x.double())
    with pytest.raises(ValueError, match="CUDA"):
        lay.from_grouped_many(x, torch.zeros(64, 8))
    assert not kernels.LAUNCHES


def test_relayout_on_side_stream(state):
    """A launch under `torch.cuda.stream(s)` runs on s: with the default
    stream held asleep, s finishes the relayout and the result is read on
    s while the default stream still sleeps."""
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = [torch.randn(s, device="cuda", generator=g) for s in MIXED[:4]]
    refs = [x.t().contiguous() for x in xs]
    lay.to_grouped_many(*xs)  # the library built and loaded beforehand
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    torch.cuda._sleep(1 << 30)  # about half a second on the default stream
    with torch.cuda.stream(s):
        assert kernels.stream() == s.cuda_stream
        ys = lay.to_grouped_many(*xs)
        s.synchronize()
        same = all(torch.equal(y, r) for y, r in zip(ys, refs))
    assert not torch.cuda.default_stream().query(), "the sleep ended early"
    torch.cuda.synchronize()
    assert same


def _mesh_poses(name):
    """(plane-mesh plan, geom_xpos, geom_xmat) of a configuration: the
    torque humanoid dropped (256 envs), G1 (`g1_states`, 4096), `wide`'s
    34 slots (256) and Talos's group at k = P (`talos_states`, 4096, the
    mega plan's tables: the kernel ranks every pair there)."""
    if name == "rk4":
        model = _model()
        d = _dropped(model)
    elif name == "g1":
        model, d = _g1_state(4096)
    elif name == "wide":
        model = _model({"contact_k_plane": 34})
        d = _dropped(model)
    else:
        model, d = _kp_state("talos", 4096)
    plan = (model.plan.mesh if name == "kp" else
            next(p for p in model.mesh_kernel if p is not None))
    d = kinematics.kinematics(model, d)
    return plan, d.geom_xpos, d.geom_xmat


@pytest.mark.parametrize("name", ["rk4", "g1", "wide", "kp"])
def test_mesh_slots_match_plain(state, name):
    """The plane-mesh kernel against `mesh_slots_plain` on every env
    (chip_smoke.py's `_mesh_slots_rule`: one launch; active slots, geom
    ids and statics exact; dist 1e-6, pos 1e-5, frame 1e-6; every near
    pair's key 1e-6), at k 8 (P 75 and 18), `wide`'s k 34 and k = P."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    plan, gxp, gxm = _mesh_poses(name)
    assert (plan.k == plan.P) == (name == "kp")
    _, n_on, n_near = chip_smoke._mesh_slots_rule(torch, plan, gxp, gxm,
                                                  name)
    assert n_on > 0 and n_near > 0
    assert hc.occupancy(plan) >= 8


@pytest.mark.parametrize("n", [4093, 1])
def test_mesh_slots_ragged_and_single_env(state, n):
    """The plane-mesh kernel at a ragged env count (not a multiple of a
    block's 4 envs) and at one env, held as above."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model = _model()
    d = kinematics.kinematics(model, _dropped(model, n))
    chip_smoke._mesh_slots_rule(torch, model.mesh_kernel[1], d.geom_xpos,
                                d.geom_xmat, f"{n} envs")


def test_mesh_slots_variant_tables(state):
    """The plane-mesh kernel with the four 4-ages scalings' hull tables
    (`standins.load_variants("humanoid4ages")`, K = 4), each of 4096 envs
    reading its seeded variant's, held as above; every env on variant 0
    gives the single model's launch bit for bit; without each env's
    variant the wrapper raises before any launch."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    models = standins.load_variants("humanoid4ages", device="cuda")
    stacked, _ = io.stack_variants(models)
    plan = stacked.mesh_kernel[1]
    assert plan.K == 4
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 4, 4096),
                          dtype=torch.int32, device="cuda")
    m = io.model_at(stacked, ids)
    d = kinematics.kinematics(m, _dropped(models[0], 4096))
    _, n_on, _ = chip_smoke._mesh_slots_rule(
        torch, plan, d.geom_xpos, d.geom_xmat, "variants", env_id=ids)
    assert n_on > 0
    zero = torch.zeros_like(ids)
    one = models[0].mesh_kernel[1]
    got = hc.mesh_slots(plan, d.geom_xpos, d.geom_xmat, env_id=zero)
    ref = hc.mesh_slots(one, d.geom_xpos, d.geom_xmat)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match="variant"):
        hc.mesh_slots(plan, d.geom_xpos, d.geom_xmat)
    assert not kernels.LAUNCHES


def test_fused_nonsmooth_per_env_leaves(state):
    """The fused kernel's non-smooth layout on a randomized env's per-env
    Model (every body's mass, the torso's full inertia and the joints'
    armature per env: the row plan without its smooth stage), at 4096
    dropped envs: held to its plain version replaying the kernel's
    decisions, qacc, qfrc_constraint and efc_force_contact rel 5e-4 of
    their largest on every env; each env's armature reaches the kernel's M
    (the model's own gives another qacc_smooth)."""
    model = _model()
    roots = [j for j in model.names["joint"] if j.startswith("root")]
    conf = {"Default": {"exclude": roots,
                        "Joints": {"armature": {"uniform_range": [0.005,
                                                                  0.1]}},
                        "Inertial": {"mass": {"uniform_range_delta": 0.5}}},
            "Inertial": {"torso": {"fullinertia": {
                "uniform_range_delta": 0.02}}}}
    env = standins.make_env(model, dr=conf, n_substeps=1)
    st = env.reset_batch(4096, torch.Generator(device="cuda").manual_seed(0))
    m, d = env._apply_dr(st.data, st.env_id, st.dr)
    assert m.plan is not None and not m.plan.smooth
    d = fwd.stages(m, d.replace(qpos=_dropped(model, 4096).qpos))
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(m, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    r = hf.fused_constraint_plain(m, d, replay=(
        k.solver_niter, k.solver_taken, k.solver_ls, k.solver_rows))
    for f in ("qacc", "qacc_smooth", "qfrc_constraint", "efc_force_contact"):
        got, ref = getattr(k, f), getattr(r, f)
        err = (got - ref).abs().reshape(4096, -1).amax(1)
        assert bool((err <= 5e-4 * (float(ref.abs().max()) + 1e-9)).all()), f
    one = m.replace(dof_armature=model.dof_armature,
                    varied=m.varied - {"dof_armature"})
    other = hf.fused_constraint(one, d).qacc_smooth
    assert not torch.allclose(other, k.qacc_smooth, rtol=1e-3, atol=0)


def test_newton_matches_plain(state):
    model, d = state
    d = fwd.fwd_acceleration(model, fwd.fwd_actuation(
        model, fwd.fwd_velocity(model, d)))
    operands, options = solver.newton_inputs(model, d,
                                             con.make_constraint(model, d))
    rec = {}
    kernels.LAUNCHES.clear()
    x_k, f_k, it_k, tk_k = hn.solve(*operands, **options, record=rec)
    assert dict(kernels.LAUNCHES) == {"newton": 1}  # no relayout
    assert rec["rows"].shape[1:] == (options["iterations"],
                                     hn.row_words(operands[0].shape[1]))
    x_p, f_p, _, _ = hn.newton_plain(*operands, **options, replay=(
        it_k, tk_k, rec["ls"], rec["rows"]))
    assert float((x_k - x_p).abs().max()) < 5e-4 * float(x_p.abs().max())
    assert float((f_k - f_p).abs().max()) < 5e-4 * float(f_p.abs().max())


def test_step_launches_every_kernel(state, monkeypatch):
    """The staged path (LMT_MEGA=0) launches each of its kernels once per
    forward: the fixture's, with a row plan, the plane-mesh kernel and the
    fused kernel; a model with no plan (110 contact slots put its rows
    past 400), the plane-mesh kernel and the Newton kernel on its
    env-major operands; no relayout around any of them."""
    model, d = state
    monkeypatch.setenv("LMT_MEGA", "0")
    kernels.LAUNCHES.clear()
    out = fwd.step(model, d)
    torch.cuda.synchronize()
    assert torch.isfinite(out.qpos).all()
    f = hm.forwards_per_step(model)  # one plane-mesh launch per forward
    assert dict(kernels.LAUNCHES) == {"fused": f, "mesh_slots": f}
    wide = _model({"contact_k_plane": 34})
    assert wide.plan is None
    kernels.LAUNCHES.clear()
    out = fwd.step(wide, _dropped(wide))
    torch.cuda.synchronize()
    assert torch.isfinite(out.qpos).all()
    assert dict(kernels.LAUNCHES) == {"newton": f, "mesh_slots": f}


def test_float64_on_card_raises(state):
    """A CUDA tensor takes the kernels whatever its dtype: float64 raises
    instead of running the plain versions on the card."""
    model = io.load_model_npz(ASSET, device="cuda", dtype=torch.float64)
    d = io.make_data(model, 4)
    with pytest.raises(TypeError, match="float32"):
        fwd.fwd_position(model, d)


def _tie_envs(same, gap):
    """Envs whose active set differs from the plain version's: each must
    have a slot within 1e-5 of its margin, and they are at most 0.5%."""
    differ = ~same
    assert bool((gap[differ] < 1e-5).all()), gap[differ]
    assert int(differ.sum()) <= 0.005 * same.numel()


def _gap(d):
    return (d.contact.dist - d.contact.includemargin).abs().min(dim=1).values


def _replay(k):
    """A kernel's recorded Newton decisions, for its plain version."""
    return (k.solver_niter, k.solver_taken, k.solver_ls, k.solver_rows)


def _fused_plain(model, d, k, **kw):
    """The fused kernel's plain version replaying its decisions; an
    elliptic plan's in float64, as the kernel's elliptic instance
    solves."""
    return hf.fused_constraint_plain(model, d, replay=_replay(k),
                                     solve64=model.plan.elliptic, **kw)


def test_mega_forward_matches_plain(state):
    model, d = state
    d = d.replace(qvel=_qvel(E, model.nv, 0))
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert kernels.LAUNCHES["mega_forward"] == 1
    assert set(kernels.LAUNCHES) == {"mega_forward"}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_k = k.contact.dist < k.contact.includemargin
    act_r = r.contact.dist < r.contact.includemargin
    assert act_r.any()
    same = torch.all(act_k == act_r, dim=1)
    _tie_envs(same, _gap(r))
    for name in ("qacc", "qfrc_constraint", "efc_force_contact"):
        got, ref = getattr(k, name)[same], getattr(r, name)[same]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), name
    on = act_r & same[:, None]
    assert torch.equal(k.contact.geom2[on], r.contact.geom2[on])
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_matches_plain(state, name):
    """The fused kernel against its plain version, decisions replayed, on
    the same FK outputs and contacts, on each of DRAWS."""
    model = _model(CONFIGS[name])
    assert model.plan.pack_w == {"fric": 7, "solref": 26}.get(name, 5)
    for draw in DRAWS:
        d = _dropped(model).replace(qvel=_qvel(E, model.nv, draw))
        d = coll.collision(model, kinematics.kinematics(model, d))
        kernels.LAUNCHES.clear()
        k = hf.fused_constraint(model, d)
        assert dict(kernels.LAUNCHES) == {"fused": 1}
        r = _fused_plain(model, d, k)
        fields = ["qacc", "qfrc_constraint", "efc_force_contact"]
        assert (k.euler_dv is None) == (not model.plan.euler_dv)
        if model.plan.euler_dv:
            fields.append("euler_dv")
        assert bool((r.efc_force_contact != 0).any())
        for f in fields:
            got, ref = getattr(k, f), getattr(r, f)
            assert float((got - ref).abs().max()) < 5e-4 * float(
                ref.abs().max()), (draw, f)


def _megastep_check(model, d, n=10):
    """n substeps (a control step) of the megastep against its plain
    version, decisions replayed (act too, with muscles)."""
    E = d.qpos.shape[0]
    per = hm.forwards_per_step(model)
    dec = torch.zeros((E, per * n, hm.decision_width(model)),
                      dtype=torch.int32, device="cuda")
    kernels.LAUNCHES.clear()
    k = fwd.step_n(model, d, n)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    k = hm.mega_step_n(model, d, n, decisions=dec)
    gaps = []
    r = hm.mega_step_n_plain(model, d, n, replay=dec,
                             on_forward=lambda o: gaps.append(_gap(o)))
    gap = torch.stack(gaps).min(dim=0).values
    ok = torch.ones(E, dtype=torch.bool, device="cuda")
    for name in ("qpos", "qvel") + (("act",) if model.na else ()):
        got, ref = getattr(k, name), getattr(r, name)
        ok &= (got - ref).abs().max(dim=1).values < 5e-4 * float(
            ref.abs().max())
    _tie_envs(ok, gap)
    assert torch.allclose(k.time, d.time + n * model.opt.timestep)
    assert torch.equal(k.qacc, k.qacc_warmstart)


def test_megastep_matches_plain(state):
    _megastep_check(*state)


def test_euler_megastep_matches_plain(state):
    """The Euler branch (qvel += dt euler_dv, qpos += dt qvel), one
    forward per substep."""
    model = _model(CONFIGS["euler"])
    _megastep_check(model, fwd.fwd_position(model, _dropped(model),
                                            plain=True))


def _muscle_state(draw=0):
    """The muscle model and its dropped state, with seeded muscle ctrls
    and activations (a quarter above 1 at full control), qvel of
    `draw`."""
    model = _model(asset=MUSCLE_ASSET)
    rng = np.random.default_rng(1)
    act = seeded_act(rng, E, model.na)
    ctrl = hold_ctrl(model, rng.uniform(0, 1, size=(E, model.nu)), act)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    d = _dropped(model).replace(qvel=_qvel(E, model.nv, draw), ctrl=t(ctrl),
                                act=t(act))
    return model, d


def test_muscle_mega_forward_matches_plain(state):
    """The mega forward with the muscle block: qacc, qfrc_constraint,
    efc_force_contact and act_dot."""
    model, d = _muscle_state()
    assert model.plan.mega and model.plan.mp is not None
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    same = torch.all((k.contact.dist < k.contact.includemargin)
                     == (r.contact.dist < r.contact.includemargin), dim=1)
    _tie_envs(same, _gap(r))
    for name in ("qacc", "qfrc_constraint", "efc_force_contact", "act_dot"):
        got, ref = getattr(k, name)[same], getattr(r, name)[same]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), name


def test_muscle_megastep_matches_plain(state):
    """The Euler megastep carrying act, clamped to [0, 1]."""
    model, d = _muscle_state()
    _megastep_check(model, d)
    out = fwd.step_n(model, d, 10)
    assert bool(((out.act >= 0) & (out.act <= 1)).all())


def test_muscle_fused_matches_plain(state, monkeypatch):
    """The fused kernel in the non-smooth layout, on the staged stages'
    outputs, decisions replayed, on each of DRAWS."""
    monkeypatch.setenv("LMT_MEGA", "0")
    for draw in DRAWS:
        model, d = _muscle_state(draw)
        d = fwd.stages(model, d)
        kernels.LAUNCHES.clear()
        k = hf.fused_constraint(model, d)
        assert dict(kernels.LAUNCHES) == {"fused": 1}
        r = _fused_plain(model, d, k)
        for f in ("qacc", "qfrc_constraint", "efc_force_contact",
                  "euler_dv"):
            got, ref = getattr(k, f), getattr(r, f)
            assert float((got - ref).abs().max()) < 5e-4 * float(
                ref.abs().max()), (draw, f)


def _a1_state(n=E):
    """The committed A1-shaped model on the card and `a1_states`' seeded
    states of it (standing, legs touching each other, tipped over)."""
    from test_torch_a1_fixture import ASSET as A1_ASSET
    from test_torch_a1_fixture import a1_states

    model = io.load_model_npz(A1_ASSET, device="cuda")
    qpos, qvel, ctrl = a1_states(io.load_model_npz(A1_ASSET, device="cpu"),
                                 n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl))


def test_a1_mega_forward_matches_plain(state):
    """The mega forward with the extended collision and elliptic rows:
    active slots and both geom ids exact, qacc, qfrc_constraint,
    efc_force_contact and euler_dv rel 5e-4."""
    model, d = _a1_state()
    assert model.plan.mega_ell and model.plan.elliptic
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    _tie_envs(same, _gap(r))
    for name in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, name)[same], getattr(r, name)[same]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), name
    on = act_r & same[:, None]
    assert bool((on & (r.contact.geom1 != 0)).any()), "no self pair active"
    for name in ("geom1", "geom2"):
        assert torch.equal(getattr(k.contact, name)[on],
                           getattr(r.contact, name)[on]), name
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5


def test_a1_megastep_matches_plain(state):
    """The Euler megastep with the extended collision and elliptic rows."""
    _megastep_check(*_a1_state())


def test_a1_fused_matches_plain(state, monkeypatch):
    """The fused kernel's elliptic layout (29-float pack) on the staged
    collision's slots, decisions replayed: every env within rel 5e-4, or
    a Newton disagreement that `chip_smoke.py`'s float64 witness settles
    for the kernel (its rule for the elliptic fused check), at most 0.5%
    of the envs."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _a1_state()
    assert model.plan.pack_w == 29
    d = fwd.stages(model, d)
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(model, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    r = _fused_plain(model, d, k)
    held = torch.ones(E, dtype=torch.bool, device="cuda")
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f), getattr(r, f)
        held &= ((got - ref).abs().reshape(E, -1).amax(1)
                 < 5e-4 * float(ref.abs().max()))
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  staged=True)
    excused = ~held & apart & witnessed
    assert bool((held | excused).all()), (~held).nonzero().flatten()
    assert int(excused.sum()) <= 0.005 * E


def test_a1_standalone_newton_raises(state):
    """Elliptic rows have no standalone Newton kernel (the reference keeps
    XLA there): a CUDA tensor raises rather than running the plain version
    on the card."""
    model, d = _a1_state(8)
    d = fwd.fwd_acceleration(model, fwd.fwd_actuation(
        model, fwd.fwd_velocity(model, fwd.fwd_position(model, d))))
    operands, options = solver.newton_inputs(model, d,
                                             con.make_constraint(model, d))
    assert options["ell"] is not None
    with pytest.raises(NotImplementedError, match="elliptic"):
        hn.solve(*operands, **options)


@pytest.mark.parametrize("n", [4093, 1])
def test_mega_ragged_and_single_env(state, n):
    """Both mega kernels at an env count that is no multiple of a block's
    envs, and at one env, against their plain versions (decisions
    replayed; chip_smoke.py's tie rule on active sets)."""
    model = _model(CONFIGS["euler"])
    d = _dropped(model, n).replace(qvel=_qvel(n, model.nv, 0))
    d = d.replace(ctrl=torch.full((n, model.nu), 0.1, device="cuda"))
    k = fwd.forward(model, d)
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    same = torch.all((k.contact.dist < k.contact.includemargin)
                     == (r.contact.dist < r.contact.includemargin), dim=1)
    if n > 1:
        _tie_envs(same, _gap(r))
    else:
        assert bool(same.all())
    for name in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, name)[same], getattr(r, name)[same]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), name
    _megastep_check(model, d, n=2)


def test_mega_bit_deterministic(state):
    """Two launches of each mega kernel on the same inputs, another
    launch between, are bit-equal in every output."""
    model, d = state
    d = d.replace(qvel=_qvel(E, model.nv, 14))
    other = d.replace(qvel=_qvel(E, model.nv, 27))
    dec = [torch.zeros((E, 8, hm.decision_width(model)), dtype=torch.int32,
                       device="cuda") for _ in range(2)]
    runs = []
    for i in range(2):
        f = hm.mega_forward(model, d)
        hm.mega_forward(model, other)
        s = hm.mega_step_n(model, d, 2, decisions=dec[i])
        hm.mega_step_n(model, other, 2)
        runs.append([f.qacc, f.qacc_smooth, f.qfrc_constraint,
                     f.efc_force_contact, f.contact.dist, f.solver_niter,
                     f.solver_taken, f.solver_ls, f.solver_rows, s.qpos,
                     s.qvel, s.qacc, dec[i]])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dr", [False, True])
@pytest.mark.parametrize("name", ["rk4", "a1", "g1arms"])
def test_fused_warp_launch_occupancy(state, name, dr):
    """Each instance of the fused kernel (pyramidal and elliptic, with and
    without the damping rows, both widths) leaves at least RESIDENT_FLOOR
    warps resident per SM at its launch, by the CUDA runtime's count
    (registers and shared memory)."""
    model = {"rk4": lambda: _model(), "a1": lambda: _a1_state(1)[0],
             "g1arms": lambda: _g1arms_state(1)[0]}[name]()
    if dr:
        model = model.replace(plan=model.plan.dyn_damping())
    launch = fused_launch(model.plan)
    assert hf.occupancy(model) >= RESIDENT_FLOOR, launch.table()
    assert launch.resident_warps >= RESIDENT_FLOOR


@pytest.mark.parametrize("width", [24, 32])
def test_newton_warp_launch_occupancy(state, width):
    """The Newton kernel at both widths (456 rows at nv 19, 455 at nv 29)
    leaves at least RESIDENT_FLOOR warps resident per SM."""
    nv, nefc = (19, 456) if width == 24 else (29, 455)
    assert hn.occupancy(nv, nefc, 0, 0) >= RESIDENT_FLOOR


@pytest.mark.parametrize("n", [4093, 1])
def test_warp_solve_ragged_and_single_env(state, n):
    """The fused kernel (Euler: euler_dv too) and the Newton kernel at an
    env count that is no multiple of a block's envs, and at one env,
    against their plain versions replaying their decisions."""
    model = _model(CONFIGS["euler"])
    d = _dropped(model, n).replace(qvel=_qvel(n, model.nv, 0))
    d = coll.collision(model, kinematics.kinematics(model, d))
    k = hf.fused_constraint(model, d)
    r = _fused_plain(model, d, k)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f), getattr(r, f)
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    wide = _model({"contact_k_plane": 34})
    dw = fwd.fwd_position(wide, _dropped(wide, n), plain=True)
    dw = fwd.fwd_acceleration(wide, fwd.fwd_actuation(
        wide, fwd.fwd_velocity(wide, dw)))
    operands, options = solver.newton_inputs(wide, dw,
                                             con.make_constraint(wide, dw))
    rec = {}
    x_k, f_k, it_k, tk_k = hn.solve(*operands, **options, record=rec)
    x_p, f_p, _, _ = hn.newton_plain(*operands, **options, replay=(
        it_k, tk_k, rec["ls"], rec["rows"]))
    assert float((x_k - x_p).abs().max()) < 5e-4 * float(x_p.abs().max())
    assert float((f_k - f_p).abs().max()) < 5e-4 * float(f_p.abs().max())


def test_warp_solve_bit_deterministic(state):
    """Two launches of the fused and the Newton kernel on the same inputs,
    another launch between, are bit-equal in every output."""
    model = _model(CONFIGS["euler"])
    d = coll.collision(model, kinematics.kinematics(
        model, _dropped(model).replace(qvel=_qvel(E, model.nv, 14))))
    other = d.replace(qvel=_qvel(E, model.nv, 27))
    wide = _model({"contact_k_plane": 34})
    dw = fwd.fwd_position(wide, _dropped(wide), plain=True)
    dw = fwd.fwd_acceleration(wide, fwd.fwd_actuation(
        wide, fwd.fwd_velocity(wide, dw)))
    operands, options = solver.newton_inputs(wide, dw,
                                             con.make_constraint(wide, dw))
    runs = []
    for _ in range(2):
        f = hf.fused_constraint(model, d)
        hf.fused_constraint(model, other)
        rec = {}
        out = hn.solve(*operands, **options, record=rec)
        runs.append([f.qacc, f.qacc_smooth, f.qfrc_constraint,
                     f.efc_force_contact, f.euler_dv, f.solver_niter,
                     f.solver_taken, f.solver_ls, f.solver_rows, *out,
                     rec["ls"], rec["rows"]])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["mega", "a1", "fused"])
def test_replayed_row_decisions_are_the_plain_versions_own(state, name):
    """The plain version's own row tests at each step's x against the
    kernel's recorded row decisions that it replays (the mega forward on
    the torque humanoid and on A1, the fused kernel on draw 14): at the
    first Newton step, from the shared start, they depart in at most 0.5%
    of the envs (chip_smoke.py's _row_departures)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    own = {}
    if name == "fused":
        model = _model(CONFIGS["rk4"])
        d = _dropped(model).replace(qvel=_qvel(E, model.nv, 14))
        d = coll.collision(model, kinematics.kinematics(model, d))
        k = hf.fused_constraint(model, d)
        _fused_plain(model, d, k, record=own)
    else:
        model, d = state if name == "mega" else _a1_state()
        if name == "mega":
            d = d.replace(qvel=_qvel(E, model.nv, 0))
        k = fwd.forward(model, d)
        hm.mega_forward_plain(model, d, replay=_replay(k), record=own)
    assert bool((k.solver_rows != 0).any())
    chip_smoke._row_departures(torch, k, own["own_rows"], E, name)


@pytest.mark.parametrize("name", ["rk4", "a1", "h1", "g1"])
def test_mega_forward_points_match_plain(state, name):
    """The mega forward's slot points (`points=True`, which the megastep
    rule reads) against its plain version's, plane-only (the torque
    humanoid, H1), extended elliptic (A1) and extended pyramidal (G1)
    instances: at the slots active in both
    with the same geom, within 1e-5 (the depth's bound), except in at most
    0.5% of the envs (a support-vertex tie moves a point by a vertex
    spacing)."""
    if name == "rk4":
        model, d = state
    elif name == "a1":
        model, d = _a1_state()
    elif name == "g1":
        model, d = _g1_state(E)
    else:
        model, d = _biped_state(name, E)
    k = hm.mega_forward(model, d, points=True)
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    on = ((k.contact.dist < k.contact.includemargin)
          & (r.contact.dist < r.contact.includemargin)
          & (k.contact.geom2 == r.contact.geom2))
    assert bool(on.any())
    err = (k.contact.pos - r.contact.pos).abs().amax(-1)
    off = ((err > 1e-5) & on).any(1)
    assert int(off.sum()) <= 0.005 * off.numel(), off.nonzero().flatten()
    assert float(err[on & ~off[:, None]].max()) <= 1e-5


def _biped_state(name, n):
    """A committed biped with a plane-cylinder group on the card and
    `biped_states`' seeded states of it (env 0's heel discs upright on the
    floor, env 1's on their rim)."""
    from test_torch_atlas_fixture import ASSET as ATLAS_ASSET
    from test_torch_h1_fixture import ASSET as H1_ASSET
    from test_torch_h1_fixture import biped_states

    asset = {"h1": H1_ASSET, "atlas": ATLAS_ASSET}[name]
    model = io.load_model_npz(asset, device="cuda")
    qpos, qvel, ctrl = biped_states(io.load_model_npz(asset, device="cpu"),
                                    n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl))


@pytest.mark.parametrize("n", [4096, 4093, 1])
@pytest.mark.parametrize("name", ["h1", "atlas"])
def test_cyl_mega_forward_matches_plain(state, name, n):
    """The mega forward with the plane-only collision's cylinder branch
    (H1: pairs in order; Atlas: the top-K of the cylinder and box groups):
    active slots and geom2 exact, qacc, qfrc_constraint, efc_force_contact
    (and H1's euler_dv) rel 5e-4; the upright and the rim envs (0 and 1)
    match with no tie excuse."""
    model, d = _biped_state(name, n)
    assert model.plan.mega and "cyl" in [g["kind"] for g in model.plan.groups]
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    assert bool(same[:2].all()), "an upright or rim env differs"
    if n > 1:
        _tie_envs(same, _gap(r))
    fields = ["qacc", "qfrc_constraint", "efc_force_contact"]
    if model.plan.euler_dv:
        fields.append("euler_dv")
    for f in fields:
        got, ref = getattr(k, f)[same], getattr(r, f)[same]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    on = act_r & same[:, None]
    g = next(g for g in model.groups if g.t2 == 5)  # the cylinder group
    assert bool(on[0, g.offset:g.offset + g.k * g.slots].any())
    assert torch.equal(k.contact.geom2[on], r.contact.geom2[on])
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5


@pytest.mark.parametrize("n", [4096, 4093, 1])
@pytest.mark.parametrize("name", ["h1", "atlas"])
def test_cyl_megastep_matches_plain(state, name, n):
    """The megastep (H1 Euler, Atlas RK4) with the cylinder branch, a
    whole control step (10 substeps; 2 at the ragged count and at one
    env, as test_mega_ragged_and_single_env), held to chip_smoke.py's
    megastep rule (`_megastep_rule`: rel 5e-4 with the decisions
    replayed; ties within 0.5% of the envs)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _biped_state(name, n)
    steps = 10 if n == 4096 else 2
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, steps)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    k = chip_smoke._megastep_rule(torch, model, d, steps, name)[0]
    assert torch.allclose(k.time, d.time + steps * model.opt.timestep)
    assert torch.equal(k.qacc, k.qacc_warmstart)


# ---- G1: the extended collision with pyramidal rows and a plane-mesh group


def _g1_state(n):
    """The committed G1-shaped model on the card and `g1_states`' seeded
    states of it (env 0 standing, envs 1-3 with each self group in
    contact)."""
    from test_torch_g1_fixture import ASSET as G1_ASSET
    from test_torch_g1_fixture import g1_states

    model = io.load_model_npz(G1_ASSET, device="cuda")
    qpos, qvel, ctrl = g1_states(io.load_model_npz(G1_ASSET, device="cpu"),
                                 n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl))


def test_g1_mega_forward_matches_plain(state):
    """The mega forward's extended pyramidal instance (G1) at 4096 envs:
    chip_smoke.py's rule for the mega forward (active slots exact, geom1
    and geom2 exact on them, depths atol 1e-5; qacc, qfrc_constraint,
    efc_force_contact and euler_dv rel 5e-4 with the decisions replayed;
    float32 ties and witnessed Newton disagreements within 0.5% of the
    envs); the standing env and the self-contact envs 1-3 with no tie
    excuse."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _g1_state(4096)
    assert hm.ext_mode(model.plan) == 2
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    assert bool(same[:4].all()), "a standing or self-contact env differs"
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  envs=same)
    held = same & ~(apart & witnessed)
    chip_smoke._tie_envs(torch, held, _gap(r), 4096, "G1 mega forward",
                         newton=apart & witnessed)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f)[held], getattr(r, f)[held]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    on = act_r & same[:, None]
    for f in ("geom1", "geom2"):
        assert torch.equal(getattr(k.contact, f)[on],
                           getattr(r.contact, f)[on]), f
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5
    for g in model.groups:  # every group held in contact
        assert bool(on[:, g.offset:g.offset + g.k * g.slots].any()), g[:3]


def test_g1_megastep_matches_plain(state):
    """G1's Euler megastep (the extended pyramidal instance), a control
    step of 10 substeps at 4096 envs, held to chip_smoke.py's megastep
    rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _g1_state(4096)
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    k = chip_smoke._megastep_rule(torch, model, d, 10, "g1")[0]
    assert torch.allclose(k.time, d.time + 10 * model.opt.timestep)


def test_g1_fused_matches_plain(state, monkeypatch):
    """G1's staged path at 4096 envs: the plane-mesh kernel and
    the torch narrowphases of the other groups, then the fused kernel with
    the generic 26-float pack against its plain version replaying its
    decisions, every env within rel 5e-4 (qacc, qfrc_constraint,
    efc_force_contact, euler_dv)."""
    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _g1_state(4096)
    assert model.plan.pack_w == 26
    kernels.LAUNCHES.clear()
    d = coll.collision(model, kinematics.kinematics(model, d))
    k = hf.fused_constraint(model, d)
    assert dict(kernels.LAUNCHES) == {
        "fused": 1, "mesh_slots": 1}
    r = _fused_plain(model, d, k)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f), getattr(r, f)
        err = (got - ref).abs().reshape(4096, -1).amax(1)
        bad = err >= 5e-4 * float(ref.abs().max())
        assert not bool(bad.any()), (f, bad.nonzero().flatten())


# ---- per-env joint damping (the damping rows) and the env layer ----------


def _with_damping(model, d, seed=3):
    """The plan's damping-row variant and each env's damping: the model's
    times U(0.3, 3) per env and dof (numpy, seeded)."""
    base = model.dof_damping.cpu().numpy()
    dd = base[None] * np.random.default_rng(seed).uniform(
        0.3, 3.0, size=(d.qpos.shape[0], model.nv))
    return (model.replace(plan=model.plan.dyn_damping()),
            d.replace(dof_damping=torch.as_tensor(dd, dtype=torch.float32,
                                                  device="cuda")))


def _dr_state(name, n=4096):
    """(DR model, data) of the torque humanoid (RK4, dropped, qvel draw 0)
    or of A1 (`a1_states`), n envs."""
    if name == "a1":
        model, d = _a1_state(n)
    else:
        model = _model()
        d = _dropped(model, n).replace(qvel=_qvel(n, model.nv, 0))
    return _with_damping(model, d)


@pytest.mark.parametrize("name", ["rk4", "a1"])
def test_dr_mega_forward_matches_plain(state, name):
    """The mega forward with the damping rows, plane-only (RK4 humanoid)
    and extended (A1) instances, at 4096 envs: chip_smoke.py's rule for the
    mega forward (active slots exact; qacc, qfrc_constraint and
    efc_force_contact rel 5e-4 with the decisions replayed; float32 ties
    and witnessed Newton disagreements within 0.5% of the envs)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _dr_state(name)
    assert model.plan.sm_dyn_damping and not model.plan.euler_dv
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    assert k.euler_dv is None
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  envs=same)
    held = same & ~(apart & witnessed)
    chip_smoke._tie_envs(torch, held, _gap(r), d.qpos.shape[0],
                         f"DR mega forward {name}", newton=apart & witnessed)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact"):
        got, ref = getattr(k, f)[held], getattr(r, f)[held]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    # the rows move the answer: the model's own damping gives another
    base = fwd.forward(_model() if name == "rk4" else _a1_state()[0],
                       d.replace(dof_damping=None))
    assert float((base.qacc - k.qacc).abs().max()) > 1e-3


def test_dr_megastep_matches_plain(state):
    """The RK4 megastep with the damping rows, a control step at 4096
    envs, held to chip_smoke.py's megastep rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _dr_state("rk4")
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    chip_smoke._megastep_rule(torch, model, d, 10, "DR rk4")


@pytest.mark.parametrize("name", ["rk4", "a1"])
def test_dr_fused_matches_plain(state, name, monkeypatch):
    """The fused kernel with the damping rows, smooth (RK4 humanoid) and
    elliptic (A1) layouts, at 4096 envs, decisions replayed: every env
    within rel 5e-4, or (elliptic) a Newton disagreement the float64
    witness settles, at most 0.5% of the envs."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _dr_state(name)
    n = d.qpos.shape[0]
    d = coll.collision(model, kinematics.kinematics(model, d))
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(model, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    r = _fused_plain(model, d, k)
    held = torch.ones(n, dtype=torch.bool, device="cuda")
    for f in ("qacc", "qfrc_constraint", "efc_force_contact"):
        got, ref = getattr(k, f), getattr(r, f)
        held &= ((got - ref).abs().reshape(n, -1).amax(1)
                 < 5e-4 * float(ref.abs().max()))
    if name == "a1":
        apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                      staged=True)
        excused = ~held & apart & witnessed
        assert bool((held | excused).all()), (~held).nonzero().flatten()
        assert int(excused.sum()) <= 0.005 * n
    else:
        assert bool(held.all()), (~held).nonzero().flatten()


def _step_batch_check(model, dr, monkeypatch, what):
    """`LocoEnv.step_batch` of a stand-in's env on the card (one megastep
    launch) against the same step with the megastep's plain version
    replaying its decisions: the physics held to chip_smoke.py's megastep
    rule, then obs, reward, absorbing and done of the held envs (rel 5e-4;
    the booleans exact)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    env = standins.make_env(
        model, dr=standins.damping_dr(model) if dr else None,
        horizon=chip_smoke.ENV_HORIZON)
    st = env.reset_batch(4096, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    a = 0.3 * (2 * torch.rand((4096, env.action_dim), device="cuda",
                              generator=g) - 1)
    def fresh_rng(s):  # both steps' auto-resets draw the same numbers
        return s.replace(rng=torch.Generator(device="cuda").manual_seed(5))

    kernels.LAUNCHES.clear()
    k = env.step_batch(fresh_rng(st), a)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    m, d = env._apply_dr(st.data.replace(
        ctrl=a * env.norm_act_delta + env.norm_act_mean), st.env_id, st.dr)
    ks, _, _, _, errs, dec = chip_smoke._megastep_rule(torch, m, d, 10, what)
    assert torch.equal(ks.qpos[~k.done], k.data.qpos[~k.done])
    held = torch.ones(4096, dtype=torch.bool, device="cuda")
    for err, scl in errs.values():
        held &= err <= 5e-4 * scl
    monkeypatch.setattr(fwd, "step_n", lambda m_, d_, n_: (
        hm.mega_step_n_plain(m_, d_, n_, replay=dec)))
    r = env.step_batch(fresh_rng(st), a)
    for f in ("absorbing", "done"):
        assert torch.equal(getattr(k, f)[held], getattr(r, f)[held]), f
    for f in ("obs", "reward"):
        got, ref = getattr(k, f)[held], getattr(r, f)[held]
        assert float((got - ref).abs().max()) <= 5e-4 * float(
            ref.abs().max()), f


@pytest.mark.parametrize("dr", [False, True])
def test_step_batch_matches_plain(state, dr, monkeypatch):
    """The torque humanoid's env (RK4), without and with damping
    randomization (`_step_batch_check`)."""
    _step_batch_check(_model(), dr, monkeypatch, f"env dr={dr}")


def test_g1_step_batch_matches_plain(state, monkeypatch):
    """G1's env (Euler, the extended pyramidal megastep; its own fall
    predicate) (`_step_batch_check`)."""
    model, _ = _g1_state(1)
    assert standins.standin_kind(model) == "g1"
    _step_batch_check(model, False, monkeypatch, "env g1")


# ---- affine gain and bias in the smooth stage: A1's position mode --------


def _a1pos_state(n):
    """The committed A1 position stand-in on the card and `a1_states`'
    seeded states of it, the servos' targets `servo_targets` (uniform in
    the joint ranges)."""
    from test_torch_a1_fixture import POSITION_ASSET, a1_states, servo_targets

    model = io.load_model_npz(POSITION_ASSET, device="cuda")
    cpu = io.load_model_npz(POSITION_ASSET, device="cpu")
    qpos, qvel, _ = a1_states(cpu, n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(
        qpos=t(qpos), qvel=t(qvel), ctrl=t(servo_targets(cpu, n)))


def test_a1pos_mega_forward_matches_plain(state):
    """The mega forward's extended elliptic instance with the servos'
    affine bias at 4096 envs, held to chip_smoke.py's rule for the mega
    forward (as test_g1_mega_forward_matches_plain)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _a1pos_state(4096)
    assert hm.ext_mode(model.plan) == 1
    assert all(a["b_affine"] for a in model.plan.sm_acts)
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  envs=same)
    held = same & ~(apart & witnessed)
    chip_smoke._tie_envs(torch, held, _gap(r), 4096, "a1pos mega forward",
                         newton=apart & witnessed)
    for f in ("qacc", "qacc_smooth", "qfrc_constraint", "efc_force_contact",
              "euler_dv"):
        got, ref = getattr(k, f)[held], getattr(r, f)[held]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    on = act_r & same[:, None]
    for f in ("geom1", "geom2"):
        assert torch.equal(getattr(k.contact, f)[on],
                           getattr(r.contact, f)[on]), f
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5


def test_a1pos_megastep_matches_plain(state):
    """A1 position mode's Euler megastep, a control step of 10 substeps
    at 4096 envs, held to chip_smoke.py's megastep rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _a1pos_state(4096)
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    k = chip_smoke._megastep_rule(torch, model, d, 10, "a1pos")[0]
    assert torch.allclose(k.time, d.time + 10 * model.opt.timestep)


def test_a1pos_fused_matches_plain(state, monkeypatch):
    """The fused kernel's elliptic layout with the servos' affine bias in
    its smooth stage, decisions replayed (test_a1_fused_matches_plain's
    rule), and its qacc_smooth on every env."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _a1pos_state(E)
    d = fwd.stages(model, d)
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(model, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    r = _fused_plain(model, d, k)
    assert float((k.qacc_smooth - r.qacc_smooth).abs().max()) < 5e-4 * float(
        r.qacc_smooth.abs().max())
    held = torch.ones(E, dtype=torch.bool, device="cuda")
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f), getattr(r, f)
        held &= ((got - ref).abs().reshape(E, -1).amax(1)
                 < 5e-4 * float(ref.abs().max()))
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  staged=True)
    excused = ~held & apart & witnessed
    assert bool((held | excused).all()), (~held).nonzero().flatten()
    assert int(excused.sum()) <= 0.005 * E


def test_a1pos_step_batch_matches_plain(state, monkeypatch):
    """A1 position mode's env (the actions unnormalized into the joint
    ranges; A1's fall predicate) (`_step_batch_check`)."""
    model, _ = _a1pos_state(1)
    assert standins.standin_kind(model) == "a1"
    _step_batch_check(model, False, monkeypatch, "env a1pos")


def test_affine_humanoid_megastep_matches_plain(state):
    """The plane-only instance with affine motors: the committed torque
    humanoid with each motor's gain and bias made affine
    (`test_torch_fixture.AFFINE_GAIN` / `AFFINE_BIAS`, the arrays MuJoCo
    compiles from `humanoid_xml(affine=True)`'s actuators), RK4, seeded
    ctrls, one control step held as test_megastep_matches_plain."""
    from test_torch_fixture import AFFINE_BIAS, AFFINE_GAIN

    leaves, aux = io.read_model_npz(ASSET)
    nu = int(aux["nu"])
    for kind, prm in (("gain", AFFINE_GAIN), ("bias", AFFINE_BIAS)):
        aux[f"actuator_{kind}type"] = np.ones(nu, dtype=np.int32)
        leaves[f"actuator_{kind}prm"] = np.array(leaves[f"actuator_{kind}prm"])
        leaves[f"actuator_{kind}prm"][:, :3] = prm
    model = io.model_from_numpy(leaves, aux, device="cuda")
    assert model.plan.mega and not model.plan.mega_ell
    assert all(a["g_affine"] and a["b_affine"] for a in model.plan.sm_acts)
    ctrl = np.random.default_rng(4).uniform(-0.3, 0.3, size=(E, nu))
    d = _dropped(model).replace(ctrl=torch.as_tensor(
        ctrl, dtype=torch.float32, device="cuda"))
    _megastep_check(model, fwd.fwd_position(model, d, plain=True))


# ---- G1 with its arms: the second compiled width (nv 29) -----------------


def _g1arms_state(n):
    """The committed G1-with-arms stand-in on the card (nv 29: the library
    compiled at width 32, the rows' J in the launch's global scratch) and
    `g1_states`' seeded states of it."""
    from test_torch_g1_fixture import ASSET_ARMS, g1_states

    model = io.load_model_npz(ASSET_ARMS, device="cuda")
    qpos, qvel, ctrl = g1_states(io.load_model_npz(ASSET_ARMS, device="cpu"),
                                 n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl))


def test_g1arms_mega_forward_matches_plain(state):
    """G1 with its arms at 4096 envs: the wide library's extended
    pyramidal mega forward, J in global scratch, held as
    `test_g1_mega_forward_matches_plain` holds G1's."""
    from loco_mujoco_tpu_torch.ops.plan import (RESIDENT_FLOOR, fused_launch,
                                            mega_launch)

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _g1arms_state(4096)
    assert model.plan.nvm == 32 and mega_launch(model.plan).j_global
    assert min(hm.occupancy(model)) >= 4
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    assert bool(same[:4].all()), "a standing or self-contact env differs"
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  envs=same)
    held = same & ~(apart & witnessed)
    chip_smoke._tie_envs(torch, held, _gap(r), 4096, "G1 arms mega forward",
                         newton=apart & witnessed)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f)[held], getattr(r, f)[held]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    on = act_r & same[:, None]
    for f in ("geom1", "geom2"):
        assert torch.equal(getattr(k.contact, f)[on],
                           getattr(r.contact, f)[on]), f
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5


def test_g1arms_megastep_matches_plain(state):
    """G1 with its arms: the wide Euler megastep, a control step of 10
    substeps at 4096 envs, held to chip_smoke.py's megastep rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _g1arms_state(4096)
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    k = chip_smoke._megastep_rule(torch, model, d, 10, "g1arms")[0]
    assert torch.allclose(k.time, d.time + 10 * model.opt.timestep)


def test_g1arms_fused_matches_plain(state, monkeypatch):
    """G1 with its arms on the staged path: the fused kernel of the wide
    library (26-float pack) against its plain version replaying its
    decisions, every env within rel 5e-4."""
    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _g1arms_state(4096)
    d = coll.collision(model, kinematics.kinematics(model, d))
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(model, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    r = _fused_plain(model, d, k)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv"):
        got, ref = getattr(k, f), getattr(r, f)
        err = (got - ref).abs().reshape(4096, -1).amax(1)
        bad = err >= 5e-4 * float(ref.abs().max())
        assert not bool(bad.any()), (f, bad.nonzero().flatten())


def test_g1arms_newton_matches_plain(state):
    """The standalone Newton kernel at width 32 on G1-with-arms' staged
    rows (make_constraint at 4096 envs), against its plain version
    replaying its decisions: qacc and forces rel 5e-4 on every env but
    those where the two part and the converged float64 witness settles it
    for the kernel (chip_smoke.py's rule, at most 0.5% of the envs). The
    kernel records the iteration count, the taken steps, the line
    search's sign tests and the rows' Hessian decisions, and the plain
    version replays them all."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _g1arms_state(4096)
    d = fwd.fwd_position(model, d, plain=True)
    d = fwd.fwd_acceleration(model, fwd.fwd_actuation(
        model, fwd.fwd_velocity(model, d)))
    operands, options = solver.newton_inputs(model, d,
                                             con.make_constraint(model, d))
    assert operands[0].shape[2] == 29
    kernels.LAUNCHES.clear()
    rec = {}
    x_k, f_k, it_k, tk_k = hn.solve(*operands, **options, record=rec)
    assert kernels.LAUNCHES["newton"] == 1
    x_p, f_p, _, _ = hn.newton_plain(*operands, **options, replay=(
        it_k, tk_k, rec["ls"], rec["rows"]))
    scale = float(x_p.abs().max())
    apart = (x_k - x_p).abs().amax(1) >= 5e-4 * scale
    witnessed = torch.zeros_like(apart)
    idx = apart.nonzero().flatten()
    if len(idx):
        sub = [t[idx].double() for t in operands[:8]]
        x_c = hn.newton_plain(*sub, x_k[idx].double(), **dict(
            options, iterations=chip_smoke.WITNESS_ITERATIONS,
            ls_iterations=chip_smoke.WITNESS_ITERATIONS, tol=1e-14))[0]
        e_k = (x_k[idx].double() - x_c).abs().amax(1) / scale
        e_p = (x_p[idx].double() - x_c).abs().amax(1) / scale
        witnessed[idx] = (e_k <= 5e-4) & (e_k <= e_p)
    held = ~apart
    chip_smoke._tie_envs(torch, held, torch.full((4096,), float("inf"),
                                                 device="cuda"), 4096,
                         "G1 arms Newton kernel", newton=witnessed)
    assert float((f_k - f_p)[held].abs().max()) < 5e-4 * float(
        f_p.abs().max())


def test_g1arms_step_batch_matches_plain(state, monkeypatch):
    """G1-with-arms' env without damping randomization
    (`_step_batch_check`)."""
    model, _ = _g1arms_state(1)
    assert standins.standin_kind(model) == "g1"
    _step_batch_check(model, False, monkeypatch, "env g1arms")


def test_wide_uncompiled_instance_raises(state, monkeypatch):
    """At nv 25-32 every instance but the extended elliptic one is
    compiled (no elliptic plan passes nv 24): a plan taken for elliptic
    there raises the named error on a CUDA tensor, with no launch, and the
    wide library's launcher itself refuses that instance."""
    model, d = _g1arms_state(8)
    monkeypatch.setattr(hm, "ext_mode", lambda plan: 1)
    kernels.LAUNCHES.clear()
    with pytest.raises(NotImplementedError, match="no elliptic instance"):
        hm.mega_forward(model, d)
    assert not kernels.LAUNCHES
    monkeypatch.undo()
    lib = hm.library(model.plan)
    out = (ctypes.c_int * 2)()
    launch = mega_launch(model.plan)
    assert lib.lmt_mega_occupancy(
        launch.env_floats, launch.envs_per_block, 1, 0,
        ctypes.cast(out, ctypes.c_void_p)) != 0


# ---- H1 and Atlas with their arms: the plane-only instance at width 32 ----


def _arms_state(name, n):
    """A committed biped with its arms on the card (`h1arms`: nv 25, J in
    shared memory; `atlasarms`: nv 31, J in the launch's global scratch;
    both on the wide library's plane-only instance) and `biped_states`'
    seeded states of it."""
    from test_torch_h1_fixture import biped_states

    model = standins.load_standin(name, device="cuda")
    qpos, qvel, ctrl = biped_states(
        standins.load_standin(name, device="cpu"), n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl))


def _mega_forward_rule(model, d, what, upright=True):
    """chip_smoke.py's rule for the mega forward: active slots exact,
    geom2 exact on them, depths atol 1e-5; qacc, qfrc_constraint,
    efc_force_contact (and euler_dv) rel 5e-4 with the decisions
    replayed; float32 ties and witnessed Newton disagreements within 0.5%
    of the envs; `upright`: envs 0 and 1 (heel discs upright and on their
    rim) held with no excuse."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    n = d.qpos.shape[0]
    kernels.LAUNCHES.clear()
    k = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"mega_forward": 1}
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all((k.contact.dist < k.contact.includemargin) == act_r,
                     dim=1)
    apart, witnessed = chip_smoke._newton_witness(torch, model, d, k, r,
                                                  envs=same)
    held = same & ~(apart & witnessed)
    if upright:
        assert bool(held[:2].all()), "an upright or rim env differs"
    chip_smoke._tie_envs(torch, held, _gap(r), n, what,
                         newton=apart & witnessed)
    fields = ["qacc", "qfrc_constraint", "efc_force_contact"]
    if model.plan.euler_dv:
        fields.append("euler_dv")
    for f in fields:
        got, ref = getattr(k, f)[held], getattr(r, f)[held]
        assert float((got - ref).abs().max()) < 5e-4 * float(
            ref.abs().max()), f
    on = act_r & same[:, None]
    assert torch.equal(k.contact.geom2[on], r.contact.geom2[on])
    assert float((k.contact.dist - r.contact.dist).abs()[on].max()) <= 1e-5
    return k


@pytest.mark.parametrize("name", ["h1arms", "atlasarms"])
def test_arms_mega_forward_matches_plain(state, name):
    """H1 (J in shared memory) and Atlas (J in the global scratch) with
    their arms at 4096 envs: the wide library's plane-only mega forward
    (`_mega_forward_rule`)."""
    model, d = _arms_state(name, 4096)
    plan = model.plan
    assert plan.nvm == 32 and plan.mega and not plan.mega_ell
    assert hm.ext_mode(plan) == 0 and "cyl" in [g["kind"]
                                               for g in plan.groups]
    assert mega_launch(plan).j_global == (name == "atlasarms")
    assert min(hm.occupancy(model)) >= 4
    _mega_forward_rule(model, d, f"{name} mega forward")


@pytest.mark.parametrize("name", ["h1arms", "atlasarms"])
def test_arms_megastep_matches_plain(state, name):
    """The wide plane-only megastep (H1 with its arms Euler, Atlas with
    its arms RK4), a control step of 10 substeps at 4096 envs, held to
    chip_smoke.py's megastep rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _arms_state(name, 4096)
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    k = chip_smoke._megastep_rule(torch, model, d, 10, name)[0]
    assert torch.allclose(k.time, d.time + 10 * model.opt.timestep)


def _fused_rule(model, d, what):
    """The fused kernel of the model's width against its plain version
    replaying its decisions: every env within rel 5e-4."""
    n = d.qpos.shape[0]
    d = coll.collision(model, kinematics.kinematics(model, d))
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(model, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}, what
    r = _fused_plain(model, d, k)
    fields = ["qacc", "qfrc_constraint", "efc_force_contact"]
    if model.plan.euler_dv:
        fields.append("euler_dv")
    for f in fields:
        got, ref = getattr(k, f), getattr(r, f)
        err = (got - ref).abs().reshape(n, -1).amax(1)
        bad = err >= 5e-4 * float(ref.abs().max())
        assert not bool(bad.any()), (what, f, bad.nonzero().flatten())


@pytest.mark.parametrize("name", ["h1arms", "atlasarms"])
def test_arms_fused_matches_plain(state, name, monkeypatch):
    """The bipeds with their arms on the staged path: the fused kernel at
    width 32 (the 5-float pack), every env within rel 5e-4."""
    monkeypatch.setenv("LMT_MEGA", "0")
    _fused_rule(*_arms_state(name, 4096), f"{name} fused")


def _wide_dr_state(name, n=4096):
    """(DR model, data) of a stand-in past the first width: Atlas with its
    arms (RK4, `biped_states`) or G1 with its arms (Euler, `g1_states`),
    each env's damping from `_with_damping`."""
    model, d = (_g1arms_state(n) if name == "g1arms"
                else _arms_state(name, n))
    return _with_damping(model, d)


@pytest.mark.parametrize("name", ["atlasarms", "g1arms"])
def test_wide_dr_mega_forward_matches_plain(state, name):
    """The mega forward with the damping rows at width 32: the plane-only
    (Atlas with its arms) and extended pyramidal (G1 with its arms, the
    per-substep forward of its Euler DR env) instances at 4096 envs
    (`_mega_forward_rule`); the rows move the answer."""
    model, d = _wide_dr_state(name)
    assert model.plan.nvm == 32 and model.plan.sm_dyn_damping
    k = _mega_forward_rule(model, d, f"{name} DR mega forward",
                           upright=name != "g1arms")
    assert k.euler_dv is None
    base = standins.load_standin(name, device="cuda")
    own = fwd.forward(base, d.replace(dof_damping=None))
    assert float((own.qacc - k.qacc).abs().max()) > 1e-3


def test_wide_dr_megastep_matches_plain(state):
    """Atlas with its arms: the RK4 megastep with the damping rows at
    width 32, a control step at 4096 envs, held to chip_smoke.py's
    megastep rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _wide_dr_state("atlasarms")
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    chip_smoke._megastep_rule(torch, model, d, 10, "DR atlasarms")


@pytest.mark.parametrize("name", ["atlasarms", "g1arms"])
def test_wide_dr_fused_matches_plain(state, name, monkeypatch):
    """The fused kernel with the damping rows at width 32 (the 5-float and
    26-float packs), every env within rel 5e-4."""
    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _wide_dr_state(name)
    assert model.plan.nvm == 32 and model.plan.sm_dyn_damping
    _fused_rule(model, d, f"{name} DR fused")


@pytest.mark.parametrize("name,dr", [("h1arms", False), ("atlasarms", False),
                                     ("atlasarms", True)])
def test_arms_step_batch_matches_plain(state, name, dr, monkeypatch):
    """The arms envs (H1's and Atlas's own fall predicates; Atlas's with
    damping randomization too: the RK4 megastep with the rows)
    (`_step_batch_check`)."""
    model, _ = _arms_state(name, 1)
    assert standins.standin_kind(model) == name[:-4]
    _step_batch_check(model, dr, monkeypatch, f"env {name} dr={dr}")


# ---- plane-mesh groups at k = P: the mega kernels rank every pair ----------


def _kp_state(name, n):
    """A committed stand-in whose plane-mesh group is at k = P, on the
    card (`talos`: the plane-only instance beside a plane-box group;
    `g1kp`: the small G1 at plane budget 10, the extended pyramidal
    instance) and seeded states of it (`talos_states`, `g1_states`)."""
    from test_torch_g1_fixture import g1_states
    from test_torch_talos_fixture import talos_states

    model = standins.load_standin(name, device="cuda")
    states = talos_states if name == "talos" else g1_states
    qpos, qvel, ctrl = states(standins.load_standin(name, device="cpu"), n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return model, io.make_data(model, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl))


def _kp_group(model):
    gi = next(i for i, g in enumerate(model.groups) if coll.is_plane_mesh(g))
    return gi, model.groups[gi]


@pytest.mark.parametrize("name", ["talos", "g1kp"])
def test_kp_mega_forward_matches_plain(state, name):
    """The mega forward with a plane-mesh group at k = P at 4096 envs:
    chip_smoke.py's rule (`_mega_forward_rule`, geom1 exact too), and the
    kernel's group in rank order: its active pairs first, by depth (the
    reference's mega kernels' order), where the staged path keeps the
    pairs in order."""
    model, d = _kp_state(name, 4096)
    gi, g = _kp_group(model)
    plan = model.plan
    assert g.k == len(g.pair_ids) and model.mesh_kernel[gi] is None
    assert plan.mega and plan.mesh is not None and plan.mesh.k == g.k
    assert hm.ext_mode(plan) == (0 if name == "talos" else 2)
    assert min(hm.occupancy(model)) >= 4
    k = _mega_forward_rule(model, d, f"{name} mega forward", upright=False)
    r = hm.mega_forward_plain(model, d, replay=_replay(k))
    on = (r.contact.dist < r.contact.includemargin)
    assert torch.equal(k.contact.geom1[on], r.contact.geom1[on])
    first = g.offset + g.slots * torch.arange(g.k, device="cuda")
    depth = k.contact.dist[:, first]  # each rank's support depth
    act = depth < k.contact.includemargin[:, first]
    assert int((act.sum(1) >= 2).sum()) > 100, "too few ranked pairs"
    assert not bool((~act[:, :-1] & act[:, 1:]).any()), "inactive first"
    both = act[:, :-1] & act[:, 1:]
    assert bool((depth[:, :-1] <= depth[:, 1:])[both].all()), "unranked"


@pytest.mark.parametrize("name", ["talos", "g1kp"])
def test_kp_megastep_matches_plain(state, name):
    """The megastep with a plane-mesh group at k = P (Euler), a control
    step of 10 substeps at 4096 envs, held to chip_smoke.py's megastep
    rule."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    model, d = _kp_state(name, 4096)
    kernels.LAUNCHES.clear()
    fwd.step_n(model, d, 10)
    assert dict(kernels.LAUNCHES) == {"megastep": 1}
    chip_smoke._megastep_rule(torch, model, d, 10, name)


def test_talos_staged_keeps_the_pair_order(state, monkeypatch):
    """Talos on the staged path: its plane-mesh group at k = P in torch in
    pair order (no plane-mesh kernel launch), the fused kernel (5-float pack)
    every env within rel 5e-4 of its plain version (`_fused_rule`)."""
    monkeypatch.setenv("LMT_MEGA", "0")
    model, d = _kp_state("talos", 4096)
    kernels.LAUNCHES.clear()
    s = fwd.forward(model, d)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    p = coll.collision(model.to(device="cpu", dtype=torch.float64),
                       kinematics.kinematics(model.to(
                           device="cpu", dtype=torch.float64),
                           d.to(device="cpu", dtype=torch.float64)))
    assert torch.equal(s.contact.geom2.cpu(), p.contact.geom2)
    _fused_rule(model, d, "talos fused")


def test_talos_step_batch_matches_plain(state, monkeypatch):
    """Talos's env (Euler, the plane-only megastep with its plane-mesh
    group at k = P; its own fall predicate) (`_step_batch_check`)."""
    model, _ = _kp_state("talos", 1)
    assert standins.standin_kind(model) == "talos"
    _step_batch_check(model, False, monkeypatch, "env talos")
