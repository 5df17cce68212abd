"""The mega path on the card: one forward, or a whole control step, as one
kernel launch.

Counterpart of `loco_mujoco_tpu/ops/pallas_constraint.py`: `mega_forward`
(`:2486-2556`, with `_pad_slots` `:2475`) over `_mega_batched`, and
`mega_step_n` (`:2926-2978`) over `_megastep_batched`, RK4 and Euler
branches, with the tendon and muscle stage of a plan with muscles (`mp`;
`:1245-1264`, `:2762-2787`) and the extended collision and elliptic rows
of a `mega_ell` plan (A1's elliptic rows, G1's pyramidal ones with its
plane-mesh group; `_mega_ell_finish` `:2559-2610`), and each
env's joint damping (`Data.dof_damping`) for a plan with `sm_dyn_damping`
(the reference's operand rows, `:2505`, `:2967`). The kernels
are `csrc/mega.cu`'s `mega_forward_kernel` and `megastep_kernel` (each in
a plane-only, an extended elliptic and an extended pyramidal instance,
`ext_mode`), one warp per env with the env's
state in shared memory, over the static tables of the model's row plan
(`ops/plan.py`, `mega` set); the launch (shared floats per env, envs per
block, and past the first nv width where shared memory runs short the
rows' J in a global scratch) is the plan's `mega_launch`, which raises
where the state leaves fewer than `plan.RESIDENT_FLOOR` warps resident per
SM. A plan with nv 25-32 runs the library compiled at the second width
(`kernels.width_defines`), which holds the plane-only and the extended
pyramidal instances, with and without the damping rows; an elliptic plan
there (which `plan.RowPlan` never builds past nv 24) raises (`library`).

Output contract (the reference's): `mega_forward` returns Data with
`qacc`, `qacc_smooth`, `qfrc_constraint`, `efc_force_contact` (the four
facet forces of each pyramidal slot, or the dim rows of each elliptic
slot, zero-padded to the field's width), `euler_dv` (None unless the plan
has it), `act_dot` (with muscles), the contact meta `dist`, `geom1` (the
plane, or with `mega_ell` the kernel's, self pairs included), `geom2`, the
static `includemargin` and `friction` (with `mega_ell` per slot from its
group's statics), and the Newton decisions `solver_niter` /
`solver_taken` / `solver_ls` / `solver_rows`; slots of a convex tail are
padded inactive; the slots' points `pos` only where asked (`points`, the
checks'; the plain version always has them); every other position- and
velocity-stage field stays as it came in (stale).
`mega_step_n` returns Data with `qpos`, `qvel`, `act` (Euler with muscles:
act += dt act_dot, clamped to actrange, every substep), `qacc =
qacc_warmstart` = the carried warm start and `time + n dt`, or None outside
the envelope (`megastep_mode`).

A CUDA tensor launches the kernel (float32 only) or raises; a CPU tensor
runs the plain version. The plain versions are no new copy of the math:
`mega_forward_plain` is the staged forward of a model with a plan, in its
plain versions (`plain_stages`: `forward.stages` with the plain collision,
its slots in the kernels' order, a plane-mesh group at k = P ranked as the
kernels rank it where the staged path keeps it in pair order: kinematics and
collision for a smooth plan, and for the muscle humanoid's non-smooth plan
also com_pos, the tendons, velocity, passive, rne and actuation, then
`hopper_fused.fused_constraint_plain`, whose rows, contact facets blocked,
are the ones the kernel builds), repackaged into the contract above, and
`mega_step_n_plain` is n such RK4 or Euler steps; with the extended
collision and elliptic cones both solve the Newton problem in float64, as
the kernels do (with pyramidal cones, G1's, in float32). Their `replay` makes
every Newton solve take the kernel's recorded decisions (the iteration
count, the taken-step bits, the line search's sign tests and each step's
Hessian decisions of the rows, `hopper_newton.newton_plain`), so the two
can be held step for step; nothing on the card's main path calls them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.types import Data, DisableBit, IntegratorType, Model
from . import hopper_fused, kernels
from . import hopper_newton as hn
from .collision import BIG
from .kernels import FLOAT, INT, PTR
from .plan import mega_launch

_SIGNATURES = {
    "lmt_mega_forward": [PTR] * 25 + [INT] * 6 + [FLOAT, FLOAT, PTR],
    "lmt_megastep": [PTR] * 16 + [INT] * 9 + [FLOAT] * 3 + [PTR],
    "lmt_mega_occupancy": [INT] * 4 + [PTR],
}


def ext_mode(plan) -> int:
    """The kernels' instance of a plan's collision and rows (`csrc/mega.cu`
    LMT_INSTANCE): 0 the plane-only collision; with the extended collision
    (`mega_ell`) 1 for elliptic cones (elliptic rows, the float64 solve)
    and 2 for pyramidal cones (the facet rows, the float32 solve)."""
    if not plan.mega_ell:
        return 0
    return 1 if plan.elliptic else 2


def library(plan, defines=()):
    """The compiled mega kernels of the plan's nv width (`plan.nvm`), with
    the macros `defines` besides. Past the first width every instance but
    the extended elliptic one is compiled (elliptic plans stop at nv 24,
    as the reference's do); an elliptic plan there raises."""
    if plan.nvm != kernels.NV_WIDTHS[0] and ext_mode(plan) == 1:
        raise NotImplementedError(
            f"the mega kernels at nv {plan.nv} (width {plan.nvm}) have no "
            f"elliptic instance: elliptic plans stop at nv "
            f"{kernels.NV_WIDTHS[0]}")
    return kernels.library("mega", _SIGNATURES,
                           kernels.width_defines(plan.nvm) + tuple(defines))


def decision_width(model: Model) -> int:
    """int32 words of one forward's record in the megastep's `decisions`:
    the iteration count, the taken-step bits, the line search's bits
    (`hopper_newton.LS_WORDS`) and each Newton step's Hessian decisions of
    the rows (`hopper_newton.row_bits`, iterations x row words)."""
    plan = model.plan
    return 2 + hn.LS_WORDS + plan.iterations * hn.row_words(plan.nrows)


def decisions_of(d: Data) -> torch.Tensor:
    """(E, decision_width) record of the forward whose Data is `d` (its
    solver_* fields), in the megastep's layout."""
    E = d.solver_niter.shape[0]
    return torch.cat([d.solver_niter[:, None], d.solver_taken[:, None],
                      d.solver_ls, d.solver_rows.reshape(E, -1)], dim=1)


def replay_of(model: Model, rec: torch.Tensor) -> tuple:
    """`decisions_of`'s inverse: (iters, taken, ls, rows) for a replay."""
    plan = model.plan
    E = rec.shape[0]
    w = 2 + hn.LS_WORDS
    return (rec[:, 0], rec[:, 1], rec[:, 2:w],
            rec[:, w:].reshape(E, plan.iterations, -1))


def occupancy(model: Model) -> tuple:
    """Resident warps (envs) per SM of (the mega forward, the megastep) at
    the model's launch, from the CUDA runtime (needs the card)."""
    plan = model.plan
    launch = mega_launch(plan)
    out = (ctypes.c_int * 2)()
    lib = library(plan)
    kernels.check(lib.lmt_mega_occupancy(
        launch.env_floats, launch.envs_per_block, ext_mode(plan),
        int(plan.sm_dyn_damping), ctypes.cast(out, ctypes.c_void_p)),
        "mega occupancy")
    return out[0], out[1]


def _inputs(model: Model, data: Data):
    """The per-env operands of both kernels, checked (env-major): the
    last is the per-env damping of a plan with `sm_dyn_damping`, or None."""
    E, nv, nu, nb = data.qpos.shape[0], model.nv, model.nu, model.nbody
    xfrc = data.xfrc_applied.reshape(E, nb * 6)
    ops = [("qpos", data.qpos, (E, nv)), ("qvel", data.qvel, (E, nv)),
           ("act", data.act, (E, model.na)), ("ctrl", data.ctrl, (E, nu)),
           ("qfrc_applied", data.qfrc_applied, (E, nv)),
           ("xfrc_applied", xfrc, (E, nb * 6)),
           ("qacc_warmstart", data.qacc_warmstart, (E, nv))]
    damp = hopper_fused.damping_rows(model.plan, data)
    if damp is not None:
        ops.append(("dof_damping", damp, (E, nv)))
    for name, t, shape in ops:
        kernels.require(t, name, shape)
    return [t for _, t, _ in ops] + ([] if damp is not None else [None])


def _pad(x, full: int, fill=0):
    """Slots (E, ncon, ...) padded to the model's `full` slots (the convex
    tail, inactive)."""
    if x.shape[1] == full:
        return x
    pad = torch.full((x.shape[0], full - x.shape[1], *x.shape[2:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _pack(model: Model, data: Data, qacc, qacc_smooth, qfrc, cdist, cgid,
          cgid1, cforce, dv, act_dot, iters, taken, ls, rows,
          cpos=None) -> Data:
    """The mega output contract (see the module note) on top of `data`;
    `cpos` the slots' points, where asked."""
    plan = model.plan
    E, ncon, full = qacc.shape[0], plan.ncon, model.ncon
    dt, dev = qacc.dtype, qacc.device
    efc = hopper_fused.contact_forces(plan, cforce,
                                      data.efc_force_contact.shape[2])
    if plan.mega_ell:  # per-slot statics of the groups (_mega_ell_finish)
        incl = [d["statics"][1] for d in plan.ext
                for _ in range(d["k"] * d["slots"])]
        fric = [d["statics"][9:14] for d in plan.ext
                for _ in range(d["k"] * d["slots"])]
        includemargin = torch.tensor(incl, dtype=dt, device=dev).expand(
            E, ncon)
        friction = torch.tensor(fric, dtype=dt, device=dev).expand(E, ncon, 5)
        geom1 = cgid1.to(torch.int64)
    else:
        includemargin = torch.full((E, ncon), plan.c_margin, dtype=dt,
                                   device=dev)
        friction = torch.tensor(plan.c_fric5, dtype=dt,
                                device=dev).expand(E, ncon, 5)
        geom1 = torch.full((E, ncon), plan.plane_gid, dtype=torch.int64,
                           device=dev)
    contact = data.contact.replace(
        dist=_pad(cdist, full, BIG), geom1=_pad(geom1, full),
        geom2=_pad(cgid.to(torch.int64), full),
        includemargin=_pad(includemargin.clone(), full),
        friction=_pad(friction.clone(), full),
        dim=np.concatenate([plan.con_dim, data.contact.dim[ncon:]]))
    if cpos is not None:
        contact = contact.replace(pos=_pad(cpos, full))
    return data.replace(qacc=qacc, qacc_smooth=qacc_smooth,
                        qfrc_constraint=qfrc,
                        efc_force_contact=_pad(efc, full),
                        contact=contact, euler_dv=dv, act_dot=act_dot,
                        solver_niter=iters, solver_taken=taken,
                        solver_ls=ls, solver_rows=rows)


def mega_forward(model: Model, data: Data, points: bool = False) -> Data:
    """One forward of every env in one kernel launch (see the module
    note). The model must have a plan with `mega`. `points`: the contact
    slots' points too (`contact.pos`), which the checks read."""
    plan = model.plan
    if plan is None or not plan.mega:
        raise ValueError("the model has no mega plan")
    if not data.qpos.is_cuda:
        return mega_forward_plain(model, data)
    lib = library(plan)
    ins = _inputs(model, data)
    qpos = ins[0]
    E, nv, ncon, dev = qpos.shape[0], model.nv, plan.ncon, qpos.device
    launch = mega_launch(plan)
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa
    i = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)  # noqa
    qacc, asm, qfrc = f(E, nv), f(E, nv), f(E, nv)
    crows = sum(plan.rows_per)  # the contact rows, slot-major
    cdist, cgid, cgid1 = f(E, ncon), i(E, ncon), i(E, ncon)
    cforce = f(E, crows)
    iters, taken, ls = i(E), i(E), i(E, hn.LS_WORDS)
    rows = i(E, plan.iterations, hn.row_words(plan.nrows))
    dv = f(E, nv) if plan.euler_dv else None
    act_dot = f(E, model.na) if plan.mp is not None else data.act_dot
    cpos = f(E, ncon, 3) if points else None
    jrows = launch.jrows(E, dev)
    ints, flts = plan.tables(dev)
    p = lambda t: None if t is None else kernels.ptr(t)  # noqa: E731
    rc = lib.lmt_mega_forward(
        p(ints), p(flts), *map(p, ins),
        *map(p, (qacc, asm, qfrc, cdist, cgid, cgid1, cforce, iters,
                 taken, ls, rows, dv, act_dot, cpos, jrows)), E,
        plan.iterations,
        plan.ls_iterations, ext_mode(plan), launch.env_floats,
        launch.envs_per_block, plan.scale, plan.tolerance, kernels.stream())
    kernels.check(rc, "mega_forward")
    kernels.LAUNCHES["mega_forward"] += 1
    return _pack(model, data, qacc, asm, qfrc, cdist, cgid, cgid1, cforce,
                 dv, act_dot, iters, taken, ls, rows, cpos)


def plain_stages(model: Model, data: Data) -> Data:
    """The stages of the mega kernels' plain version: the staged path's in
    their plain versions, with the slots in the kernels' order (a
    plane-mesh group at k = P ranked, `collision.collision(ranked=True)`)."""
    from . import forward as fwd

    return fwd.stages(model, data, plain=True, ranked=True)


def _forward_plain(model: Model, data: Data, replay, record=None) -> Data:
    """The staged forward of a model with a plan, with the plain
    kernels and the kernels' slot order (`plain_stages`); `replay` =
    (iters, taken[, ls[, rows]]) or None."""
    hopper_fused.damping_rows(model.plan, data)
    d = plain_stages(model, data)
    return hopper_fused.fused_constraint_plain(
        model, d, replay, solve64=ext_mode(model.plan) == 1, record=record)


def mega_forward_plain(model: Model, data: Data, replay=None,
                       record=None) -> Data:
    """Plain version of `mega_forward`: the staged forward with the plain
    kernels, in the mega output contract; `replay` = (iters, taken[, ls[,
    rows]]) and `record` (a dict for the solve's decisions, its own row
    decisions among them) as in `hopper_newton.newton_plain`."""
    d = _forward_plain(model, data, replay, record)
    c = d.contact
    contact = data.contact.replace(
        dist=c.dist, pos=c.pos, geom1=c.geom1, geom2=c.geom2,
        includemargin=c.includemargin, friction=c.friction, dim=c.dim)
    return data.replace(qacc=d.qacc, qacc_smooth=d.qacc_smooth,
                        qfrc_constraint=d.qfrc_constraint,
                        efc_force_contact=d.efc_force_contact,
                        contact=contact, euler_dv=d.euler_dv,
                        act_dot=d.act_dot, solver_niter=d.solver_niter,
                        solver_taken=d.solver_taken, solver_ls=d.solver_ls,
                        solver_rows=d.solver_rows)


def megastep_mode(model: Model):
    """(rk4, use_dv) of the megastep for this model, or None outside its
    envelope (the reference's gate, pallas_constraint.py:2936-2953): RK4
    without activations; Euler moving qvel by euler_dv, or by qacc when
    EULERDAMP is disabled, and the activations (each slot's clamp bounds
    are always static here: no leaf of the port is traced)."""
    plan = model.plan
    if plan is None or not plan.mega:
        return None
    if model.opt.integrator == int(IntegratorType.RK4):
        return None if model.na else (True, False)
    if model.opt.integrator == int(IntegratorType.EULER):
        if model.opt.disableflags & DisableBit.EULERDAMP:
            return False, False
        return (False, True) if plan.euler_dv else None
    return None


def forwards_per_step(model: Model) -> int:
    """Forwards per physics step: 4 for RK4, 1 for Euler."""
    return 4 if model.opt.integrator == int(IntegratorType.RK4) else 1


def mega_step_n(model: Model, data: Data, n_steps: int,
                decisions: torch.Tensor | None = None,
                defines=()) -> Data | None:
    """n_steps physics steps of every env in one kernel launch (see the
    module note), or None outside the envelope. `decisions`, an
    (E, F n_steps, decision_width) int32 tensor or None (F =
    `forwards_per_step`), receives the iteration count, the taken-step
    bits, the line search's bits and the rows' Hessian decisions of every
    forward, for `mega_step_n_plain`'s replay; with None the kernel
    records nothing. `defines`: a
    compile-time variant of `csrc/mega.cu` (`LMT_PHASES`,
    tools/megastep_phases.py)."""
    mode = megastep_mode(model)
    if mode is None:
        return None
    if not data.qpos.is_cuda:
        return mega_step_n_plain(model, data, n_steps)
    plan = model.plan
    lib = library(plan, defines)
    ins = _inputs(model, data)
    E, nv, dev = ins[0].shape[0], model.nv, ins[0].device
    n = int(n_steps)
    if decisions is not None:
        kernels.require(decisions, "decisions",
                        (E, forwards_per_step(model) * n,
                         decision_width(model)), torch.int32)
    launch = mega_launch(plan)
    f = lambda k: torch.empty((E, k), dtype=torch.float32, device=dev)  # noqa
    qpos_out, qvel_out, act_out, ws_out = f(nv), f(nv), f(model.na), f(nv)
    jrows = launch.jrows(E, dev)
    ints, flts = plan.tables(dev)
    p = lambda t: None if t is None else kernels.ptr(t)  # noqa: E731
    rc = lib.lmt_megastep(
        p(ints), p(flts), *map(p, ins), p(qpos_out), p(qvel_out),
        p(act_out), p(ws_out), p(decisions), p(jrows), E, n, plan.iterations,
        plan.ls_iterations, int(mode[0]),
        int(mode[1]), ext_mode(plan), launch.env_floats,
        launch.envs_per_block, plan.scale, plan.tolerance, plan.timestep,
        kernels.stream())
    kernels.check(rc, "megastep")
    kernels.LAUNCHES["megastep"] += 1
    return data.replace(qpos=qpos_out, qvel=qvel_out, act=act_out,
                        qacc=ws_out, qacc_warmstart=ws_out,
                        time=data.time + n * model.opt.timestep)


def mega_step_n_plain(model: Model, data: Data, n_steps: int, replay=None,
                      on_forward=None, records=None) -> Data | None:
    """Plain version of `mega_step_n`: n staged RK4 or Euler steps with
    the plain kernels. `replay`: the kernel's (E, F n_steps,
    decision_width) decisions;
    `on_forward(d)` sees the Data of every forward, in order; `records`,
    a list, receives each forward's solve record (`hopper_newton.
    newton_plain`'s `record`: its row decisions and its own tests')."""
    if megastep_mode(model) is None:
        return None
    from . import forward as fwd

    per = forwards_per_step(model)
    d = data
    for s in range(int(n_steps)):
        def stage(dd, i, s=s):
            rep = (None if replay is None else
                   replay_of(model, replay[:, per * s + i]))
            rec = None if records is None else {}
            out = _forward_plain(model, dd, rep, rec)
            if records is not None:
                records.append(rec)
            if on_forward is not None:
                on_forward(out)
            return out

        if per == 4:
            d = fwd.rk4(model, stage(d, 0), stage)
        else:
            d = fwd.euler(model, stage(d, 0))
    ws = d.qacc_warmstart
    return data.replace(qpos=d.qpos, qvel=d.qvel, act=d.act, qacc=ws,
                        qacc_warmstart=ws,
                        time=data.time + int(n_steps) * model.opt.timestep)
