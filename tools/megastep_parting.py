#!/usr/bin/env python3
"""Where and why a megastep's control step parts from its plain version's.

    python3 tools/megastep_parting.py [--configs h1 atlas]
        [--states smoke card] [--show 6] [--dump DIR]
    python3 tools/megastep_parting.py --configs rk4 --states env
    python3 tools/megastep_parting.py --analyse FILE CONFIG

For each biped configuration of `chip_smoke.py` (`BIPEDS`) and each start
state (`smoke`: the main path's end state, as the smoke's megastep check
takes it; `card`: the seeded states of `tests/test_torch_cuda.py`'s biped
tests, `biped_states` at 4096 envs; `env`, with the configuration
`rk4`, the torque humanoid's env reset and first action of
`tests/test_torch_cuda.py::test_step_batch_matches_plain`) it runs one
control step (10
substeps) of the megastep, recording its Newton decisions, and the plain
version four ways:

* `replay`: replaying the decisions the kernel recorded along its own
  trajectory (the smoke's and the card tests' comparison);
* `own`: on its own decisions (no replay);
* `own+ulp`: on its own decisions from qvel scaled by 1 + 2^-23 (one
  float32 rounding of the start), the plain version's own spread;
* `here`: at each forward, replaying the decisions that the mega forward
  kernel makes at that same state.

It prints how many envs lie past rel 5e-4 (the checks' measure: per env
the largest error over qpos, qvel (and act), over the largest |value| of
the reference) for each pairing, then for each env where the kernel
misses the replayed run (at most `--show`): its five errors, the smallest
margin gap along the replayed run, and the forward where the replay
matters most: the forward at which the replayed decisions, made by the
kernel at its own state, move the plain version's acceleration farthest
from the kernel's own forward at the plain version's state. At that
forward it gives both iteration counts, the dof that moves, and the
distance of each candidate (the replayed plain forward, the kernel's own
forward there, the plain version's own) from the state's Newton problem
solved in float64 to convergence (`chip_smoke._newton_witness`'s
witness), and how far the replay still moves it with each part of the
recorded decisions in turn (the iteration count, the taken steps, the
line search, the row decisions) taken from the kernel's own forward
there instead. For each env where the kernel and the plain version replaying
the kernel's own decisions of one state disagree, it prints that state's
readings (active slots, contact distances and forces, the decisions of
the mega kernel, the staged path's fused kernel and the plain version,
each one's distance from the converged float64 solution, each cylinder's
tilt) and, with `--dump DIR`, saves the env's state and both kernels'
outputs; `--analyse FILE CONFIG` reads such a file on any device and
walks the plain version's Newton solve, replaying the mega kernel's
decisions, step by step in float32 and float64. Needs the card (but for
`--analyse`); prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

TOL = 5e-4
FIELDS = ("qpos", "qvel", "act")


def _rel(torch, m, a, b):
    """Per env, the largest error of a against the reference b over the
    state's fields, each over the reference's largest |value|."""
    out = []
    for f in FIELDS[:3 if m.na else 2]:
        x, r = getattr(a, f), getattr(b, f)
        out.append((x - r).abs().amax(1) / (float(r.abs().max()) + 1e-9))
    return torch.stack(out).amax(0)


def _start(torch, io, fwd, cs, m, name, which, dev):
    """The control step's start state (see the module note)."""
    E = cs.N_ENVS
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa
    if which == "env":
        from loco_mujoco_tpu_torch.envs import standins

        env = standins.make_env(m, horizon=cs.ENV_HORIZON)
        st = env.reset_batch(E, torch.Generator(device=dev).manual_seed(0))
        g = torch.Generator(device=dev).manual_seed(1)
        a = 0.3 * (2 * torch.rand((E, env.action_dim), device=dev,
                                  generator=g) - 1)
        return st.data.replace(ctrl=a * env.norm_act_delta
                               + env.norm_act_mean)
    if which == "smoke":
        q, c = cs.seeded_biped(m, cs.BIPEDS[name][1], E)
        d = fwd.forward(m, io.make_data(m, E).replace(qpos=t(q)))
        for s in range(cs.CONTROL_STEPS):
            d = fwd.step_n(m, d.replace(ctrl=t(c[s])), cs.SUBSTEPS)
        return d.replace(ctrl=t(c[0]))
    from test_torch_h1_fixture import biped_states

    q, v, c = biped_states(
        io.load_model_npz(ROOT / cs.BIPEDS[name][0], device="cpu"), E)
    return io.make_data(m, E).replace(qpos=t(q), qvel=t(v), ctrl=t(c))


def _run(m, S1, n, stage_fn):
    """n substeps of the plain integration, `stage_fn(d, j)` running
    forward j (RK4: 4 per substep) at state d."""
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm

    per, d = hm.forwards_per_step(m), S1
    for s in range(n):
        def stage(dd, i, s=s):
            return stage_fn(dd, per * s + i)

        d = (fwd.rk4(m, stage(d, 0), stage) if per == 4
             else fwd.euler(m, stage(d, 0)))
    return d


def _witness(torch, m, dd, idx, cands):
    """Each candidate qacc's (rows idx) distance, rel the largest |qacc|
    among them, from the state's Newton problem solved in float64 to
    convergence."""
    import chip_smoke as cs
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn

    plan = m.plan
    _, problem, _ = hf.newton_problem(m, fwd.stages(m, dd, plain=True))
    sub = [t[idx].double() for t in problem]
    x_c = hn.newton_plain(
        *sub, cands[0][idx].double(), iterations=cs.WITNESS_ITERATIONS,
        ls_iterations=cs.WITNESS_ITERATIONS, tol=1e-14, ne=plan.ne,
        nfl=plan.nfl, scale=plan.scale)[0]
    scale = max(float(c.abs().max()) for c in cands)
    return [(c[idx].double() - x_c).abs().amax(1) / scale for c in cands]


def part(torch, m, S1, n, label, show, card, dump=None):
    import chip_smoke as cs
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn

    E, dev = S1.qpos.shape[0], S1.qpos.device
    per = hm.forwards_per_step(m)
    F = per * n
    dec = torch.zeros((E, F, hm.decision_width(m)), dtype=torch.int32,
                      device=dev)
    ks = hm.mega_step_n(m, S1, n, decisions=dec)
    states, effect, n_here, differ, gaps = [], [], [], [], []
    forced, here, shared = [], [], []

    def replayed(dd, j):
        p = hm._forward_plain(m, dd, hm.replay_of(m, dec[:, j]))
        k = hm.mega_forward(m, dd)
        ph = hm._forward_plain(m, dd, hm.replay_of(m, hm.decisions_of(k)))
        shared.append((k.qacc - ph.qacc).abs().amax(1))
        states.append(dd)
        forced.append(p.qacc)
        here.append(k.qacc)
        effect.append((p.qacc - k.qacc).abs().amax(1))
        n_here.append(k.solver_niter)
        differ.append((hm.decisions_of(k) != dec[:, j]).any(1))
        gaps.append(cs._margin_gap(m, p))
        return p

    def at_here(dd, j):
        k = hm.mega_forward(m, dd)
        return hm._forward_plain(m, dd, hm.replay_of(m, hm.decisions_of(k)))

    rs = _run(m, S1, n, replayed)
    rh = _run(m, S1, n, at_here)
    ro = hm.mega_step_n_plain(m, S1, n)
    ru = hm.mega_step_n_plain(m, S1.replace(qvel=S1.qvel * (1 + 2 ** -23)),
                              n)
    errs = {"kernel vs replay": _rel(torch, m, ks, rs),
            "kernel vs own": _rel(torch, m, ks, ro),
            "replay vs own": _rel(torch, m, rs, ro),
            "kernel vs here": _rel(torch, m, ks, rh),
            "own vs own+ulp": _rel(torch, m, ru, ro)}
    print(f"{label}: {E} envs, {F} forwards ({card}); envs past rel {TOL}: "
          + "; ".join(f"{k} {int((v > TOL).sum())} "
                      f"{torch.nonzero(v > TOL).flatten().tolist()[:12]}"
                      for k, v in errs.items()))
    qscale = max(float(f.abs().max()) for f in forced)
    eff = torch.stack(effect, 1) / qscale  # (E, F)
    nh = torch.stack(n_here, 1)
    dif = torch.stack(differ, 1)
    gap = torch.stack(gaps, 1).amin(1)
    print(f"  forwards where the kernel's own decisions at the plain "
          f"version's state differ from those it recorded along its own "
          f"trajectory: {int(dif.sum())} of {E * F} (in "
          f"{int(dif.any(1).sum())} envs); where the replayed decisions "
          f"then move the acceleration past rel {TOL}: "
          f"{int((eff > TOL).sum())} forwards in "
          f"{int((eff > TOL).any(1).sum())} envs")
    jname = {v: k for k, v in m.names["joint"].items()}
    bad = torch.nonzero(errs["kernel vs replay"] > TOL).flatten().tolist()
    for e in bad[:show]:
        j = int(eff[e].argmax())
        print(f"  env {e}: " + ", ".join(f"{k} {float(v[e]):.3g}"
                                         for k, v in errs.items())
              + f"; smallest margin gap along the replay {float(gap[e]):.3g}")
        print(f"    iterations recorded / the kernel's own at the plain "
              f"state, per forward: "
              + " ".join(f"{int(dec[e, f, 0])}/{int(nh[e, f])}"
                         for f in range(F)))
        print(f"    decisions differ at forwards "
              f"{torch.nonzero(dif[e]).flatten().tolist()}; the replay's "
              f"effect on qacc, rel, at those: "
              + " ".join(f"{float(eff[e, f]):.2g}"
                         for f in torch.nonzero(dif[e]).flatten().tolist()))
        dd = states[j]
        own = hm._forward_plain(m, dd, None)
        idx = torch.tensor([e], device=dev)
        w = _witness(torch, m, dd, idx, [here[j], forced[j], own.qacc])
        dof = int((forced[j][e] - here[j][e]).abs().argmax())
        print(f"    largest at forward {j} (substep {j // per}, stage "
              f"{j % per}): rel {float(eff[e, j]):.3g} on dof {dof} "
              f"({jname.get(int(m.dof_jntid[dof]), '?')}); iterations: "
              f"replayed {int(dec[e, j, 0])}, the kernel's own "
              f"{int(nh[e, j])}, the plain version's own "
              f"{int(own.solver_niter[e])} (budget {m.plan.iterations}); "
              f"from the float64 converged solution: the kernel's own "
              f"{float(w[0][0]):.3g}, the replayed plain "
              f"{float(w[1][0]):.3g}, the plain version's own "
              f"{float(w[2][0]):.3g}")
        # which part of the recorded decisions moves it: each part in turn
        # taken from the kernel's own decisions at this state
        k_here = hm.decisions_of(hm.mega_forward(m, dd))
        w2 = 2 + hn.LS_WORDS
        parts = {"iteration count": slice(0, 1), "taken steps": slice(1, 2),
                 "line search": slice(2, w2), "row decisions": slice(w2, None)}
        moved = []
        for part_name, sl in parts.items():
            rec = dec[:, j].clone()
            rec[:, sl] = k_here[:, sl]
            x = hm._forward_plain(m, dd, hm.replay_of(m, rec)).qacc
            gone = float((x[e] - here[j][e]).abs().max()) / qscale
            moved.append(f"{part_name} {gone:.3g}")
        print(f"    at that forward, the replay with one part of the "
              f"recorded decisions replaced by the kernel's own there, rel "
              f"from the kernel's own forward: " + ", ".join(moved))
    sh = torch.stack(shared, 1) / qscale
    apart = torch.nonzero(sh.amax(1) > TOL).flatten().tolist()
    print(f"  forwards where the kernel and the plain version replaying the "
          f"kernel's decisions at that same state lie past rel {TOL}: "
          f"{int((sh > TOL).sum())} in {len(apart)} envs {apart[:12]}")
    for e in apart[:show]:
        j = int(sh[e].argmax())
        _shared_state(torch, m, states[j], e, f"forward {j} (substep "
                      f"{j // per}, stage {j % per})", dump)
    return errs


def _shared_state(torch, m, dd, e, where, dump=None):
    """One env's kernel and plain forward at one state, the kernel's
    decisions replayed: where they part, with each cylinder's tilt."""
    import chip_smoke as cs
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn
    from loco_mujoco_tpu_torch.ops import kinematics

    k = hm.mega_forward(m, dd)
    p = hm.mega_forward_plain(m, dd, replay=hm.replay_of(
        m, hm.decisions_of(k)))
    own = hm.mega_forward_plain(m, dd)
    with cs._staged_path():
        st = fwd.forward(m, dd)
    idx = torch.tensor([e], device=dd.qpos.device)
    only = torch.zeros(dd.qpos.shape[0], dtype=torch.bool,
                       device=dd.qpos.device)
    only[e] = True
    w = _witness(torch, m, dd, idx, [k.qacc, p.qacc, own.qacc, st.qacc])
    act_k = k.contact.dist[e] < k.contact.includemargin[e]
    act_p = p.contact.dist[e] < p.contact.includemargin[e]
    on = act_k & act_p
    fk = k.efc_force_contact[e].reshape(act_k.shape[0], -1)
    fp = p.efc_force_contact[e].reshape(act_k.shape[0], -1)
    df = (fk - fp).abs().amax(1)
    worst = int(df.argmax())
    slot_kind = "?"
    for g in m.groups:
        if g.offset <= worst < g.offset + g.k * g.slots:
            slot_kind = {5: "cylinder", 6: "box", 7: "mesh"}.get(
                int(g.t2), str(int(g.t2)))
    kk = kinematics.kinematics(m, dd)
    g = next((g for g in m.groups if int(g.t2) == 5), None)
    n = torch.tensor([0.0, 0.0, 1.0], device=dd.qpos.device)
    tilts = []
    for q in range(g.k if g is not None else 0):
        sl = slice(g.offset + g.slots * q, g.offset + g.slots * (q + 1))
        gid = int(p.contact.geom2[e, sl.start])
        axis = kk.geom_xmat[e, gid, :, 2]
        dvec = axis * float(axis @ n) - n
        on_floor = " (active)" if bool(act_p[sl].any()) else ""
        tilts.append(f"geom {gid}{on_floor} |axis (axis.n) - n| "
                     f"{float(dvec.norm()):.3g}")
    same_ids = torch.equal(k.contact.geom2[e][on], p.contact.geom2[e][on])
    e_dist = float((k.contact.dist[e] - p.contact.dist[e]).abs()[on].max())
    e_smooth = float((k.qacc_smooth[e] - p.qacc_smooth[e]).abs().max()
                     / p.qacc_smooth.abs().max())
    print(f"    env {e} at {where}: Newton steps {int(k.solver_niter[e])}; "
          f"active slots same {bool(torch.equal(act_k, act_p))}, geom2 same "
          f"{same_ids}, dist max err {e_dist:.3g}; qacc_smooth rel "
          f"{e_smooth:.3g}; contact forces: largest difference at slot "
          f"{worst} ({slot_kind}"
          f", geom {int(p.contact.geom2[e, worst])}): kernel "
          f"{fk[worst].tolist()} plain {fp[worst].tolist()}")
    def dec_of(d):
        return hm.decisions_of(d)[e]

    dk, ds, do = dec_of(k), dec_of(st), dec_of(own)
    w2 = 2 + hn.LS_WORDS
    print(f"      decisions (iterations, taken, line search, rows) of the "
          f"mega kernel {int(dk[0])}, {int(dk[1])}; of the staged path's "
          f"fused kernel {int(ds[0])}, {int(ds[1])}, line search "
          f"{'same' if torch.equal(dk[2:w2], ds[2:w2]) else 'differs'}, "
          f"rows {'same' if torch.equal(dk[w2:], ds[w2:]) else 'differ'}; "
          f"of the plain version's own {int(do[0])}, {int(do[1])}, line "
          f"search {'same' if torch.equal(dk[2:w2], do[2:w2]) else 'differs'}"
          f", rows {'same' if torch.equal(dk[w2:], do[w2:]) else 'differ'}")
    if dump is not None:
        one = {f: getattr(dd, f)[e:e + 1].cpu() for f in
               ("qpos", "qvel", "act", "ctrl", "qacc_warmstart", "time")}
        one.update({f"{tag}_{f}": getattr(x, f)[e:e + 1].cpu()
                    for tag, x in (("mega", k), ("staged", st))
                    for f in ("qacc", "qfrc_constraint",
                              "efc_force_contact")})
        one.update(mega_decisions=dk[None].cpu(), staged_decisions=ds[None]
                   .cpu())
        pl, prob, _ = hf.newton_problem(m, fwd.stages(m, dd, plain=True))
        one.update({f"plain_{n}": t[e:e + 1].cpu() for n, t in zip(
            ("J", "M", "aref", "D", "R", "floss", "active", "asm"), prob)})
        one.update({f"plain_{f}": getattr(pl.contact, f)[e:e + 1].cpu()
                    for f in ("pos", "frame", "dist")})
        one.update({f"plain_{f}": getattr(pl, f)[e:e + 1].cpu()
                    for f in ("geom_xpos", "geom_xmat", "qacc_smooth")})
        path = Path(dump) / f"env{e}_{where.split()[1]}.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(one, path)
        print(f"      saved to {path}")
    print(f"      from the float64 converged solution (the plain version's "
          f"rows): kernel {float(w[0][0]):.3g}, plain replaying it "
          f"{float(w[1][0]):.3g}, plain on its own {float(w[2][0]):.3g}, "
          f"the staged path's kernels {float(w[3][0]):.3g}; support-vertex "
          f"tie in a slot that differs (chip_smoke._vertex_ties) "
          f"{bool(cs._vertex_ties(torch, m, dd, k, p, only)[e])}, top-K "
          f"rank tie (chip_smoke._rank_ties) "
          f"{bool(cs._rank_ties(torch, m, dd, k, p, only)[e])}; the "
          f"nearest margin {float(cs._margin_gap(m, p)[e]):.3g}; cylinders: "
          + ("; ".join(tilts) or "none"))


def analyse(torch, path, name):
    """A state `--dump` saved (one env): the plain version's Newton solve
    replaying the mega kernel's decisions, stopped after each step, in
    float32 and float64, each iterate's cost and its distance (rel the
    largest |qacc|) from the mega kernel's and the fused kernel's qacc."""
    import chip_smoke as cs
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn

    m = io.load_model_npz(ROOT / cs.BIPEDS[name][0], device="cpu")
    z = torch.load(path)
    d = io.make_data(m, 1).replace(**{f: z[f] for f in (
        "qpos", "qvel", "act", "ctrl", "qacc_warmstart", "time")})
    dl, problem, _ = hf.newton_problem(m, fwd.stages(m, d, plain=True))
    plan = m.plan
    opt = dict(ne=plan.ne, nfl=plan.nfl, ls_iterations=plan.ls_iterations,
               iterations=plan.iterations, scale=plan.scale,
               tol=plan.tolerance)
    rep = hm.replay_of(m, z["mega_decisions"])
    k, st = z["mega_qacc"].double(), z["staged_qacc"].double()
    scale = float(k.abs().max())
    same = torch.equal(z["mega_decisions"], z["staged_decisions"])
    print(f"{path}: mega kernel {int(rep[0][0])} Newton steps, taken bits "
          f"{int(rep[1][0])}; fused kernel's decisions "
          f"{'the same' if same else 'differ'}; mega vs fused qacc rel "
          f"{float((k - st).abs().max()) / scale:.3g}")
    for dt in (torch.float32, torch.float64):
        prob = [t.to(dt) for t in problem]
        for i in range(int(rep[0][0]) + 1):
            r = (torch.full_like(rep[0], i),) + tuple(rep[1:])
            x = hn.newton_plain(*prob, dl.qacc_warmstart.to(dt), replay=r,
                                **opt)[0].double()
            c = hn.newton_cost(*prob, x.to(dt), ne=plan.ne, nfl=plan.nfl)
            print(f"  {str(dt)[6:]} replay stopped after {i} steps: cost "
                  f"{float(c[0]):.9g}; from the mega kernel rel "
                  f"{float((x - k).abs().max()) / scale:.3g}, from the "
                  f"fused kernel {float((x - st).abs().max()) / scale:.3g}")
    for tag, x in (("mega", k), ("fused", st)):
        c = hn.newton_cost(*[t.double() for t in problem], x, ne=plan.ne,
                           nfl=plan.nfl)
        print(f"  the {tag} kernel's qacc: cost {float(c[0]):.9g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["h1", "atlas"])
    ap.add_argument("--states", nargs="+", default=["smoke", "card"])
    ap.add_argument("--show", type=int, default=6)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--analyse", nargs=2, metavar=("FILE", "CONFIG"))
    args = ap.parse_args()
    import torch

    if args.analyse:
        analyse(torch, Path(args.analyse[0]), args.analyse[1])
        return 0

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import forward as fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs._nvidia_smi()
    print(f"nvidia-smi: {card}")
    for name in args.configs:
        asset = (cs.BIPEDS[name][0] if name in cs.BIPEDS else
                 "loco_mujoco_tpu_torch/assets/humanoid_torque_shape.npz")
        m = io.load_model_npz(ROOT / asset, device=dev)
        for which in args.states:
            S1 = _start(torch, io, fwd, cs, m, name, which, dev)
            part(torch, m, S1, cs.SUBSTEPS, f"{name} {which}", args.show,
                 card, args.dump and f"{args.dump}/{name}_{which}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
