"""The mega path on the card: one forward, or a whole control step, as one
kernel launch.

Counterpart of `loco_mujoco_tpu/ops/pallas_constraint.py`: `mega_forward`
(`:2486-2556`, with `_pad_slots` `:2475`) over `_mega_batched`, and
`mega_step_n` (`:2926-2978`) over `_megastep_batched`, RK4 branch. The
kernels are `csrc/mega.cu`'s `mega_forward_kernel` and `megastep_kernel`,
one thread per env, over the static tables of the model's mega plan
(`ops/plan.py`).

Output contract (the reference's): `mega_forward` returns Data with
`qacc`, `qacc_smooth`, `qfrc_constraint`, `efc_force_contact` (the four
facet forces of each slot, zero-padded to the field's width), the contact
meta `dist`, `geom1` (the plane), `geom2`, the static `includemargin` and
`friction`, and the Newton decisions `solver_niter` / `solver_taken`;
every other position- and velocity-stage field stays as it came in
(stale). `mega_step_n` returns Data with `qpos`, `qvel`,
`qacc = qacc_warmstart` = the carried warm start and `time + n dt`, or
None outside the envelope (not RK4, activations).

A CUDA tensor launches the kernel (float32 only) or raises; a CPU tensor
runs the plain version. The plain versions are no new copy of the math:
`mega_forward_plain` is the staged forward (`forward.forward_staged`) with
the plain kernels, repackaged into the contract above, and
`mega_step_n_plain` is n staged RK4 steps. Their `replay` makes every
Newton solve take the kernel's recorded decisions (the iteration count and
the taken-step bits, `hopper_newton.newton_plain`), so the two can be held
step for step; nothing on the card's main path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Data, IntegratorType, Model
from . import kernels
from .kernels import FLOAT, INT, PTR

_SIGNATURES = {
    "lmt_mega_forward": [PTR] * 24 + [INT] * 3 + [FLOAT, FLOAT, PTR],
    "lmt_megastep": [PTR] * 20 + [INT] * 4 + [FLOAT] * 3 + [PTR],
}
_MAXD = 4  # facet rows per condim-3 pyramidal slot


def _inputs(model: Model, data: Data):
    """The per-env operands of both kernels, checked (env-major)."""
    E, nv, nu, nb = data.qpos.shape[0], model.nv, model.nu, model.nbody
    xfrc = data.xfrc_applied.reshape(E, nb * 6)
    ops = [("qpos", data.qpos, (E, nv)), ("qvel", data.qvel, (E, nv)),
           ("ctrl", data.ctrl, (E, nu)),
           ("qfrc_applied", data.qfrc_applied, (E, nv)),
           ("xfrc_applied", xfrc, (E, nb * 6)),
           ("qacc_warmstart", data.qacc_warmstart, (E, nv))]
    for name, t, shape in ops:
        kernels.require(t, name, shape)
    return [t for _, t, _ in ops]


def _scratch(plan, E, device):
    """Env-last row scratch of the solve: J, aref, D, R, act, fl, jar, jv."""
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=device)  # noqa
    rows = plan.nrows
    return [f(rows * plan.nv, E), f(rows, E), f(rows, E), f(rows, E),
            f(rows, E), f(max(plan.nfl, 1), E), f(rows, E), f(rows, E)]


def _pack(model: Model, data: Data, qacc, qacc_smooth, qfrc, cdist, cgid,
          cforce, iters, taken) -> Data:
    """The mega output contract (see the module note) on top of `data`."""
    plan = model.mega
    E, ncon = qacc.shape[0], plan.ncon
    dt, dev = qacc.dtype, qacc.device
    maxd = data.efc_force_contact.shape[2]
    efc = torch.zeros((E, ncon, maxd), dtype=dt, device=dev)
    efc[..., :_MAXD] = cforce.reshape(E, ncon, _MAXD)[..., :maxd]
    contact = data.contact.replace(
        dist=cdist,
        geom1=torch.full((E, ncon), plan.plane_gid, dtype=torch.int64,
                         device=dev),
        geom2=cgid.to(torch.int64),
        includemargin=torch.full((E, ncon), plan.c_margin, dtype=dt,
                                 device=dev),
        friction=torch.tensor(plan.c_fric5, dtype=dt,
                              device=dev).expand(E, ncon, 5).clone(),
        dim=np.asarray(plan.con_dim))
    return data.replace(qacc=qacc, qacc_smooth=qacc_smooth,
                        qfrc_constraint=qfrc, efc_force_contact=efc,
                        contact=contact, solver_niter=iters,
                        solver_taken=taken)


def mega_forward(model: Model, data: Data) -> Data:
    """One forward of every env in one kernel launch (see the module
    note). The model must have a mega plan."""
    plan = model.mega
    if plan is None:
        raise ValueError("the model has no mega plan")
    if not data.qpos.is_cuda:
        return mega_forward_plain(model, data)
    qpos, qvel, ctrl, qfrc_applied, xfrc, ws = _inputs(model, data)
    E, nv, ncon, dev = qpos.shape[0], model.nv, plan.ncon, qpos.device
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa
    i = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)  # noqa
    qacc, asm, qfrc = f(E, nv), f(E, nv), f(E, nv)
    cdist, cgid, cforce = f(E, ncon), i(E, ncon), f(E, ncon * _MAXD)
    iters, taken = i(E), i(E)
    ints, flts = plan.tables(dev)
    scratch = _scratch(plan, E, dev)
    p = kernels.ptr
    lib = kernels.library("mega", _SIGNATURES)
    rc = lib.lmt_mega_forward(
        p(ints), p(flts), *map(p, (qpos, qvel, ctrl, qfrc_applied, xfrc, ws)),
        *map(p, (qacc, asm, qfrc, cdist, cgid, cforce, iters, taken)),
        *map(p, scratch), E, plan.iterations,
        plan.ls_iterations, plan.scale, plan.tolerance, kernels.stream())
    kernels.check(rc, "mega_forward")
    kernels.LAUNCHES["mega_forward"] += 1
    return _pack(model, data, qacc, asm, qfrc, cdist, cgid, cforce, iters,
                 taken)


def mega_forward_plain(model: Model, data: Data, replay=None) -> Data:
    """Plain version of `mega_forward`: the staged forward with the plain
    kernels, in the mega output contract; `replay` = (iters, taken)."""
    from . import forward as fwd

    d = fwd.forward_staged(model, data, plain=True, replay=replay)
    c = d.contact
    contact = data.contact.replace(
        dist=c.dist, geom1=c.geom1, geom2=c.geom2,
        includemargin=c.includemargin, friction=c.friction, dim=c.dim)
    return data.replace(qacc=d.qacc, qacc_smooth=d.qacc_smooth,
                        qfrc_constraint=d.qfrc_constraint,
                        efc_force_contact=d.efc_force_contact,
                        contact=contact, solver_niter=d.solver_niter,
                        solver_taken=d.solver_taken)


def _megastep_envelope(model: Model) -> bool:
    return (model.mega is not None and model.na == 0
            and model.opt.integrator == int(IntegratorType.RK4))


def mega_step_n(model: Model, data: Data, n_steps: int,
                decisions: torch.Tensor | None = None) -> Data | None:
    """n_steps RK4 physics steps of every env in one kernel launch (see
    the module note), or None outside the envelope. `decisions`, an
    (E, 4 n_steps, 2) int32 tensor or None, receives the iteration count
    and the taken-step bits of every forward, for `mega_step_n_plain`'s
    replay; with None the kernel records nothing."""
    if not _megastep_envelope(model):
        return None
    if not data.qpos.is_cuda:
        return mega_step_n_plain(model, data, n_steps)
    plan = model.mega
    qpos, qvel, ctrl, qfrc_applied, xfrc, ws = _inputs(model, data)
    E, nv, dev = qpos.shape[0], model.nv, qpos.device
    n = int(n_steps)
    if decisions is not None:
        kernels.require(decisions, "decisions", (E, 4 * n, 2), torch.int32)
    f = lambda: torch.empty((E, nv), dtype=torch.float32, device=dev)  # noqa
    qpos_out, qvel_out, ws_out = f(), f(), f()
    ints, flts = plan.tables(dev)
    scratch = _scratch(plan, E, dev)
    p = kernels.ptr
    lib = kernels.library("mega", _SIGNATURES)
    rc = lib.lmt_megastep(
        p(ints), p(flts), *map(p, (qpos, qvel, ctrl, qfrc_applied, xfrc, ws)),
        p(qpos_out), p(qvel_out), p(ws_out),
        None if decisions is None else p(decisions),
        *map(p, scratch), E, n, plan.iterations,
        plan.ls_iterations, plan.scale, plan.tolerance, plan.timestep,
        kernels.stream())
    kernels.check(rc, "megastep")
    kernels.LAUNCHES["megastep"] += 1
    return data.replace(qpos=qpos_out, qvel=qvel_out, qacc=ws_out,
                        qacc_warmstart=ws_out,
                        time=data.time + n * model.opt.timestep)


def mega_step_n_plain(model: Model, data: Data, n_steps: int, replay=None,
                      on_forward=None) -> Data | None:
    """Plain version of `mega_step_n`: n staged RK4 steps with the plain
    kernels. `replay`: the kernel's (E, 4 n_steps, 2) decisions;
    `on_forward(d)` sees the Data of every forward, in order."""
    if not _megastep_envelope(model):
        return None
    from . import forward as fwd

    d = data
    for s in range(int(n_steps)):
        def stage(dd, i, s=s):
            rep = (None if replay is None else
                   (replay[:, 4 * s + i, 0], replay[:, 4 * s + i, 1]))
            out = fwd.forward_staged(model, dd, plain=True, replay=rep)
            if on_forward is not None:
                on_forward(out)
            return out

        d = fwd.rk4(model, stage(d, 0), stage)
    ws = d.qacc_warmstart
    return data.replace(qpos=d.qpos, qvel=d.qvel, qacc=ws, qacc_warmstart=ws,
                        time=data.time + int(n_steps) * model.opt.timestep)
