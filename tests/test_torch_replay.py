"""The Newton solve's decision record and its replay, on the CPU.

A kernel and its plain version sum in different orders, so every float32
test that picks a branch of the solve can fall apart between them where a
value sits at its threshold; the checks hold the two step for step by
replaying the kernel's decisions in the plain version
(`hopper_newton.newton_plain`'s `replay`). The record carries the warm
start, the iteration count and the taken steps (`solver_niter`,
`solver_taken`), the line search's sign tests (`solver_ls`) and each Newton
step's Hessian decision of every row (`solver_rows`: a limit or pyramidal
facet row's sign, a friction-loss row's zone, an elliptic contact's zone),
the decision the fused check missed on 2 envs of 15,360 before it was
recorded.

Here, on the committed stand-ins (the torque humanoid, the muscle humanoid
and the A1 quadruped) at 16 envs in float32: a plain solve replaying its
own recorded decisions is bit-equal to the solve that recorded them, in
every output and in the record itself; a flipped row decision changes the
replayed solve (the replay reads it); the megastep's per-forward record
(`hopper_mega.decisions_of` / `replay_of`) round-trips through
`mega_step_n_plain`, whose per-forward solve records show a forced
row decision (one the plain version's own test refuses); the row words
pack and unpack exactly; a solve replaying itself records its own row
decisions (`own_rows`, which the card checks hold against a kernel's)
equal to the replayed ones; and the mega
plain version's float64 solve of A1's elliptic problem (`solve64`, the
elliptic mega kernels' precision) is the float64 solve rounded, where the
float32 solve replaying the same decisions lies past rel 5e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from loco_mujoco_tpu_torch.ops import hopper_newton as hn
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_a1_fixture import a1_states
from test_torch_fixture import seeded_act

ASSETS = Path(__file__).resolve().parent.parent / "loco_mujoco_tpu_torch" \
    / "assets"
E = 16
FIELDS = ("qacc", "qfrc_constraint", "efc_force_contact", "euler_dv",
          "solver_niter", "solver_taken", "solver_ls", "solver_rows")


def _state(name):
    """A committed stand-in (float32, CPU) and a seeded state of it in
    contact: the humanoids dropped 15 mm with noisy qvel (the muscle model
    with seeded ctrls and activations), A1 in `a1_states`' poses."""
    rng = np.random.default_rng(3)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    if name == "a1":
        m = io.load_model_npz(ASSETS / "unitree_a1_shape.npz", device="cpu")
        qpos, qvel, ctrl = a1_states(m, E)
        return m, io.make_data(m, E).replace(qpos=t(qpos), qvel=t(qvel),
                                             ctrl=t(ctrl))
    m = io.load_model_npz(ASSETS / f"humanoid_{name}_shape.npz",
                          device="cpu")
    qpos = m.qpos0.numpy()[None] + rng.normal(scale=0.02, size=(E, m.nq))
    qpos[:, int(m.jnt_qposadr[m.names["joint"]["root_z"]])] -= 0.015
    d = io.make_data(m, E).replace(qpos=t(qpos),
                                   qvel=t(rng.normal(scale=0.3,
                                                     size=(E, m.nv))))
    if m.na:
        d = d.replace(act=t(seeded_act(rng, E, m.na)),
                      ctrl=t(rng.uniform(0, 1, size=(E, m.nu))))
    return m, d


def _staged(m, d):
    """The fused stage's inputs: FK and contacts (smooth plans), or every
    stage (the muscle model's non-smooth plan and A1's collision)."""
    if m.plan.smooth and not m.plan.elliptic:
        return coll.collision(m, kinematics.kinematics(m, d))
    return fwd.stages(m, d)


def _replay(d):
    return (d.solver_niter, d.solver_taken, d.solver_ls, d.solver_rows)


@pytest.mark.parametrize("name", ["torque", "muscle", "a1"])
def test_plain_self_replay_is_bit_equal(name):
    m, d = _state(name)
    d = _staged(m, d)
    own = hf.fused_constraint_plain(m, d)
    assert int(own.solver_niter.max()) >= 2
    assert bool((own.solver_rows != 0).any())
    rep = hf.fused_constraint_plain(m, d, replay=_replay(own))
    for f in FIELDS:
        a, b = getattr(own, f), getattr(rep, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_flipped_row_decision_changes_the_replay():
    """The replay reads the rows' Hessian decisions: flipping one active
    contact row's decision at the first step of an env that takes two or
    more steps moves its solution, and only its."""
    m, d = _state("torque")
    d = _staged(m, d)
    own = hf.fused_constraint_plain(m, d)
    rows = hn.unpack_row_bits(own.solver_rows[:, 0], m.plan.nrows)
    s0 = m.plan.nrows - sum(m.plan.rows_per)
    env = int(torch.nonzero((own.solver_niter >= 2)
                            & rows[:, s0:].any(1))[0])
    r = s0 + int(torch.nonzero(rows[env, s0:])[0])
    flipped = own.solver_rows.clone()
    flipped[env, 0, r // 32] ^= 1 << (r % 32)
    rep = hf.fused_constraint_plain(
        m, d, replay=(own.solver_niter, own.solver_taken, own.solver_ls,
                      flipped))
    moved = (rep.qacc != own.qacc).any(1)
    assert bool(moved[env]) and int(moved.sum()) == 1


@pytest.mark.parametrize("name", ["torque", "a1"])
def test_megastep_record_round_trips(name):
    """Euler steps of the mega path's plain version, each forward's
    decisions packed in the megastep's layout (`decisions_of`), replayed
    (`replay_of`): bit-equal."""
    m, d = _state(name)
    if name == "torque":
        leaves, aux = io.read_model_npz(ASSETS / "humanoid_torque_shape.npz")
        aux["opt.integrator"] = 0
        m = io.model_from_numpy(leaves, aux, device="cpu",
                                dtype=torch.float32)
    recs = []
    own = hm.mega_step_n_plain(m, d, 2, on_forward=lambda o: recs.append(
        hm.decisions_of(o)))
    dec = torch.stack(recs, dim=1)
    assert dec.shape == (E, 2, hm.decision_width(m))
    rep = hm.mega_step_n_plain(m, d, 2, replay=dec)
    for f in ("qpos", "qvel", "qacc_warmstart"):
        assert torch.equal(getattr(own, f), getattr(rep, f)), f


def test_megastep_records_forced_row_decisions():
    """`mega_step_n_plain`'s `records`: one solve record per forward; a
    run replaying its own decisions forces no row decision its own tests
    refuse (`rows` == `own_rows`, the megastep rule's forced decisions in
    chip_smoke._megastep_rule), and a flipped row decision at the first
    forward is one such decision, in that env only."""
    m, d = _state("torque")
    leaves, aux = io.read_model_npz(ASSETS / "humanoid_torque_shape.npz")
    aux["opt.integrator"] = 0
    m = io.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    decs = []
    hm.mega_step_n_plain(m, d, 2, on_forward=lambda o: decs.append(
        hm.decisions_of(o)))
    dec = torch.stack(decs, dim=1)
    recs = []
    hm.mega_step_n_plain(m, d, 2, replay=dec, records=recs)
    assert len(recs) == 2
    for rec in recs:
        assert torch.equal(rec["rows"], rec["own_rows"])
    rows = hm.replay_of(m, dec[:, 0])[3]
    first = hn.unpack_row_bits(rows[:, 0], m.plan.nrows)
    s0 = m.plan.nrows - sum(m.plan.rows_per)
    env = int(torch.nonzero((dec[:, 0, 0] >= 2) & first[:, s0:].any(1))[0])
    r = s0 + int(torch.nonzero(first[env, s0:])[0])
    w = 2 + hn.LS_WORDS  # the first Newton step's row words
    flipped = dec.clone()
    flipped[env, 0, w + r // 32] ^= 1 << (r % 32)
    recs = []
    hm.mega_step_n_plain(m, d, 2, replay=flipped, records=recs)
    forced = (recs[0]["rows"] != recs[0]["own_rows"]).flatten(1).any(1)
    assert bool(forced[env]) and int(forced.sum()) == 1


def test_row_words_pack_and_unpack():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 144, 300):
        bits = torch.as_tensor(rng.random((5, n)) < 0.5)
        bits[0] = True  # bit 31 of every word set: the int32 sign
        words = hn.row_bits(bits)
        assert words.dtype == torch.int32
        assert words.shape == (5, hn.row_words(n))
        assert torch.equal(hn.unpack_row_bits(words, n), bits)


@pytest.mark.parametrize("name", ["torque", "a1"])
def test_own_row_decisions_on_self_replay(name):
    """`record`'s `own_rows`, the row decisions the plain version's own
    tests make, equal the replayed ones where it replays itself: the mega
    path's plain version (with A1, its float64 Newton direction)."""
    m, d = _state(name)
    own = hm.mega_forward_plain(m, d)
    rec = {}
    rep = hm.mega_forward_plain(m, d, replay=_replay(own), record=rec)
    assert bool((rec["rows"] != 0).any())
    assert torch.equal(rec["own_rows"], rec["rows"])
    assert torch.equal(rec["rows"], own.solver_rows)
    for f in ("qacc", "qfrc_constraint", "efc_force_contact"):
        assert torch.equal(getattr(own, f), getattr(rep, f)), f


def test_solve64_is_the_float64_solve_rounded():
    """A1's Newton solves cut at their budget (impratio 100): the plain
    version's `solve64` (the mega kernels' solve for elliptic plans) is the
    float64 solve of the widened float32 problem, rounded once; the float32
    solve replaying the same decisions lies more than rel 5e-4 (of the
    largest) from it in qfrc_constraint. On `a1_states`' first 256 of 4096
    seeded states and the five of the 4096 where float32 solves lay
    farthest from float64."""
    m = io.load_model_npz(ASSETS / "unitree_a1_shape.npz", device="cpu")
    pick = list(range(256)) + [827, 1082, 1963, 2129, 3708]
    n = len(pick)
    qpos, qvel, ctrl = (a[pick] for a in a1_states(m, 4096))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    d = fwd.stages(m, io.make_data(m, n).replace(qpos=t(qpos), qvel=t(qvel),
                                                 ctrl=t(ctrl)), plain=True)
    rec = {}
    wide = hf.fused_constraint_plain(m, d, solve64=True, record=rec)
    p = m.plan
    assert int((wide.solver_niter == p.iterations).sum()) > n // 4
    _, problem, ell = hf.newton_problem(m, d)
    rep = (wide.solver_niter, wide.solver_taken, rec["ls"], rec["rows"])
    x64, f64 = hn.newton_plain(
        *(t.double() for t in problem), d.qacc_warmstart.double(),
        ne=p.ne, nfl=p.nfl, iterations=p.iterations,
        ls_iterations=p.ls_iterations, scale=p.scale, tol=p.tolerance,
        ell=(ell[0], ell[1].double(), ell[2].double(), ell[3]),
        replay=rep)[:2]
    assert torch.equal(wide.qacc, x64.float())
    narrow = hf.fused_constraint_plain(m, d, replay=rep)
    q64 = torch.einsum("erv,er->ev", problem[0].double()
                       * problem[6].double()[..., None], f64)
    err = (narrow.qfrc_constraint.double() - q64).abs().max()
    assert float(err) > 5e-4 * float(q64.abs().max())
