"""The fused constraint kernel on the card: the smooth stage, the
constraint rows, the Newton solve and Euler's implicit damping of one
forward as one kernel launch, from the FK outputs and the contact slots of
the staged path.

Counterpart of `loco_mujoco_tpu/ops/pallas_constraint.py`'s
`fused_constraint` (`:2204-2300`) over `_fused_batched` (`:2052`, its
`pallas_call` at `:2134`), in both vec layouts. The kernel is
`csrc/fused.cu`'s `fused_kernel`, one warp per env on the mega kernels'
stages and solve (`csrc/warp_core.cuh`), over the static tables of the
model's row plan (`ops/plan.py`), each env's state in a shared region
laid out by `plan.fused_launch` (the rows' J in a global scratch where
shared memory runs short), from the library compiled at the plan's nv
width (`plan.nvm`: 24, or 32 for nv 25-32; every pyramidal layout at
both, the elliptic one at 24). An elliptic plan's solve runs in float64,
as the mega kernels' does: its plain version is
`fused_constraint_plain(..., solve64=True)`.

`fused_constraint` packs the per-env vector of the plan's layout (smooth:
qpos, qvel, xipos, ximat, xanchor, xaxis, ctrl, qfrc_applied, xfrc_applied,
qacc_warmstart, `:2246-2256`, and with `sm_dyn_damping` each env's joint
damping, `Data.dof_damping`; non-smooth, the muscle humanoid's: qpos,
qvel, cdof, the root subtree com, cinert, qfrc_smooth, qacc_warmstart,
armature, `:2257-2264`) and the contact slots in the plan's pack width
(`:2215-2243`; elliptic plans take the generic 29-float pack with 5
frictions), launches the kernel, and writes qacc, qacc_smooth, qfrc_constraint,
efc_force_contact, euler_dv (None unless the plan has it) and the Newton
decisions `solver_niter` / `solver_taken` / `solver_ls` / `solver_rows`
(each Newton step's Hessian decision of every row). The kernel's
pyramidal facet rows are BLOCKED, facet f of slot c at row s0 + f ncon + c
(`:2279-2283`), its elliptic rows slot-major, dim rows per slot
(`:1654-1700`); `_finish` (`contact_forces`) restores efc_force_contact's
per-slot order. Every other Data field stays as it came in.

A CUDA tensor launches the kernel (float32 only) or raises; a CPU tensor
runs the plain version, `fused_constraint_plain` (`solve64` for an
elliptic plan, as the kernel solves): the same function in
plain PyTorch, from the staged path's own stages (smooth layout: com_pos,
crb, the velocity stage, passive, actuation, qacc_smooth; non-smooth: crb
and qacc_smooth from the given cinert and qfrc_smooth), `make_constraint`'s
rows
put in the fused layout (the `npad` inert rows, the blocked facets),
`hopper_newton.newton_plain` (with the elliptic contacts' cone zones where
the plan is elliptic) and `forward.damping_dv` for euler_dv. Its
`replay` = (iters, taken, ls, rows) makes the solve take another run's
discrete decisions, so the kernel can be held to it step for step; it
writes its own decisions (or the replayed ones) into the same fields.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.types import Data, Model
from . import constraint as con_mod
from . import hopper_newton as hn
from . import inertia, kernels, kinematics
from .kernels import FLOAT, INT, PTR
from .plan import fused_launch
from .support import static_tensor

_SIGNATURES = {
    "lmt_fused": [PTR] * 15 + [INT] * 8 + [FLOAT, FLOAT, PTR],
    "lmt_fused_occupancy": [INT] * 4 + [PTR],
}


def library(plan):
    """The compiled fused kernel of the plan's nv width (`plan.nvm`). Past
    the first width only the pyramidal instances are compiled (elliptic
    plans stop at nv 24, as the reference's do); an elliptic plan there
    raises."""
    if plan.nvm != kernels.NV_WIDTHS[0] and plan.elliptic:
        raise NotImplementedError(
            f"the fused kernel at nv {plan.nv} (width {plan.nvm}) has no "
            f"elliptic instance: elliptic plans stop at nv "
            f"{kernels.NV_WIDTHS[0]}")
    return kernels.library("fused", _SIGNATURES,
                           kernels.width_defines(plan.nvm))


def occupancy(model: Model) -> int:
    """Resident warps (envs) per SM of the plan's instance at its launch
    (`plan.fused_launch`), from the CUDA runtime (needs the card)."""
    plan = model.plan
    launch = fused_launch(plan)
    out = (ctypes.c_int * 1)()
    kernels.check(library(plan).lmt_fused_occupancy(
        launch.env_floats, launch.envs_per_block, int(plan.sm_dyn_damping),
        int(plan.elliptic), ctypes.addressof(out)), "fused occupancy")
    return out[0]


def smooth_vec(data: Data) -> torch.Tensor:
    """The (E, nvec) per-env vector of the smooth layout (nq == nv)."""
    E = data.qpos.shape[0]
    return torch.cat([
        data.qpos, data.qvel, data.xipos.reshape(E, -1),
        data.ximat.reshape(E, -1), data.xanchor.reshape(E, -1),
        data.xaxis.reshape(E, -1), data.ctrl, data.qfrc_applied,
        data.xfrc_applied.reshape(E, -1), data.qacc_warmstart], dim=1)


def nonsmooth_vec(model: Model, data: Data) -> torch.Tensor:
    """The (E, nvec) per-env vector of the non-smooth layout: [qpos qvel
    cdof(nv 6) com(3) cinert(nbody 10) qfrc_smooth ws armature], com the
    root's subtree com (one kinematic tree: the plan's envelope); cinert
    from each env's masses and inertias and the armature each env's where
    they vary per env (`Model.varied`; `:2257-2264`, the reference's
    per-env armature under vmap), so the kernel builds each env's M."""
    E = data.qpos.shape[0]
    root = int(model.body_rootid[1]) if model.nbody > 1 else 0
    return torch.cat([
        data.qpos, data.qvel, data.cdof.reshape(E, -1),
        data.subtree_com[:, root], data.cinert.reshape(E, -1),
        data.qfrc_smooth, data.qacc_warmstart,
        model.dof_armature.expand(E, -1)], dim=1)


def damping_rows(plan, data: Data):
    """The (E, nv) per-env damping operand (`Data.dof_damping`) of a plan
    with `sm_dyn_damping`, or None; raises where the plan and the data
    disagree (per-env damping needs the plan's `dyn_damping()` variant,
    and that variant needs it)."""
    rows = data.dof_damping
    if plan.sm_dyn_damping != (rows is not None):
        raise ValueError(
            "per-env damping (Data.dof_damping) and the plan's "
            "dyn_damping() variant go together")
    return rows


def vec(model: Model, data: Data) -> torch.Tensor:
    """The per-env vector in the plan's layout; a smooth plan with
    `sm_dyn_damping` appends each env's damping (`:2254`)."""
    plan = model.plan
    damp = damping_rows(plan, data)
    if not plan.smooth:
        return nonsmooth_vec(model, data)
    if damp is None:
        return smooth_vec(data)
    return torch.cat([smooth_vec(data), damp], dim=1)


def contact_pack(model: Model, data: Data) -> torch.Tensor:
    """The (E, ncon, pack_w) contact slots of the plan's pack (see
    csrc/fused.cu); (E, 1, pack_w) zeros with no contact rows."""
    plan = model.plan
    con, n = data.contact, plan.ncon
    E, dt = data.qpos.shape[0], data.qpos.dtype
    if not n:
        return torch.zeros((E, 1, plan.pack_w), dtype=dt,
                           device=data.qpos.device)
    if plan.uniform:
        fields = [con.pos[:, :n], con.dist[:, :n, None],
                  con.geom2[:, :n, None].to(dt)]
        if not plan.fric_uniform:
            fields.append(con.friction[:, :n, :2])
    else:
        gb = static_tensor(model, "geom_bodyid", lambda: model.geom_bodyid,
                           dtype=torch.int64)
        b1, b2 = gb[con.geom1[:, :n]], gb[con.geom2[:, :n]]
        biw = model.body_invweight0[:, 0]
        fields = [con.pos[:, :n], con.frame[:, :n].reshape(E, n, 9),
                  con.dist[:, :n, None], con.includemargin[:, :n, None],
                  con.friction[:, :n, :plan.nfric], con.solref[:, :n],
                  con.solimp[:, :n], (biw[b1] + biw[b2])[..., None],
                  b1[..., None].to(dt), b2[..., None].to(dt)]
    return torch.cat(fields, dim=-1).contiguous()


def contact_forces(plan, force, width: int) -> torch.Tensor:
    """(E, ncon, width) per-slot forces from the rows of the fused layout
    (`force` (E, nrows), or its contact rows alone, (E, nrows - s0)):
    the four facets of each pyramidal slot (blocked, facet f of slot c at
    s0 + f ncon + c), or the dim rows of each elliptic slot (slot-major
    from `con_efcadr`), zero past them."""
    n = plan.ncon
    s0 = plan.nrows - sum(plan.rows_per)
    crow = force[:, force.shape[1] - (plan.nrows - s0):]
    efc = torch.zeros((force.shape[0], n, width), dtype=force.dtype,
                      device=force.device)
    if not plan.elliptic:
        w = min(4, width)
        efc[..., :w] = crow.reshape(-1, 4, n).transpose(1, 2)[..., :w]
        return efc
    idx = np.zeros((n, width), np.int64)
    msk = np.zeros((n, width), bool)
    for c, (adr, d) in enumerate(zip(plan.con_efcadr, plan.rows_per)):
        d = min(d, width)
        idx[c, :d] = adr - s0 + np.arange(d)
        msk[c, :d] = True
    got = crow[:, torch.as_tensor(idx, device=force.device)]
    return torch.where(torch.as_tensor(msk, device=force.device), got,
                       torch.zeros_like(got))


def _finish(model: Model, data: Data, qacc, force, qfrc, asm, dv, iters,
            taken, ls, rows) -> Data:
    """The output contract (see the module note) on top of `data`; force
    holds every row in the fused layout."""
    plan = model.plan
    n = plan.ncon
    efc = torch.zeros_like(data.efc_force_contact)
    if n:
        efc[:, :n] = contact_forces(plan, force, efc.shape[2])
    return data.replace(qacc=qacc, qacc_smooth=asm, qfrc_constraint=qfrc,
                        efc_force_contact=efc, euler_dv=dv,
                        solver_niter=iters, solver_taken=taken,
                        solver_ls=ls, solver_rows=rows)


def fused_constraint(model: Model, data: Data) -> Data:
    """make_constraint + solver.solve (and Euler's damping solve) of every
    env in one kernel launch (see the module note). `data` holds the
    staged path's FK outputs and contact slots; the model must have a
    plan."""
    plan = model.plan
    if plan is None:
        raise ValueError("the model has no row plan")
    if not data.qpos.is_cuda:
        return fused_constraint_plain(model, data, solve64=plan.elliptic)
    v, pack = vec(model, data), contact_pack(model, data)
    E, nv, dev = v.shape[0], model.nv, v.device
    kernels.require(v, "vec", v.shape)
    kernels.require(pack, "contact pack", (E, max(plan.ncon, 1), plan.pack_w))
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa
    i = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)  # noqa
    qacc, qfrc, asm = f(E, nv), f(E, nv), f(E, nv)
    force = f(E, plan.nrows)
    dv = f(E, nv) if plan.euler_dv else None
    iters, taken, ls = i(E), i(E), i(E, hn.LS_WORDS)
    rows = i(E, plan.iterations, hn.row_words(plan.nrows))
    ints, flts = plan.tables(dev)
    launch = fused_launch(plan)
    shm, jrows = launch.tensor(dev), launch.jrows(E, dev)
    p = kernels.ptr
    rc = library(plan).lmt_fused(
        p(ints), p(flts), p(shm), p(v), p(pack),
        *map(p, (qacc, force, qfrc, asm)), None if dv is None else p(dv),
        p(iters), p(taken), p(ls), p(rows),
        None if jrows is None else p(jrows), E, v.shape[1],
        int(plan.sm_dyn_damping), int(plan.elliptic), plan.iterations,
        plan.ls_iterations, launch.env_floats, launch.envs_per_block,
        plan.scale, plan.tolerance, kernels.stream())
    kernels.check(rc, "fused")
    kernels.LAUNCHES["fused"] += 1
    return _finish(model, data, qacc, force, qfrc, asm, dv, iters, taken,
                   ls, rows)


def fused_rows(plan, efc: con_mod.Efc):
    """make_constraint's rows (equalities, friction loss, limits, contact
    rows slot-major) in the fused layout: `npad` inert rows (J 0, aref 0,
    R = D = 1, inactive) after the limits, then pyramidal facets blocked,
    facet f of slot c at s0 + f ncon + c, or elliptic rows slot-major, as
    they come. Returns (J, aref, D, R, floss, active)."""
    s0 = plan.ne + plan.nfl + plan.nl
    inert = efc.J.shape[1]  # the index of an appended inert row
    if plan.elliptic:  # dim rows per slot, slot-major, as make_constraint's
        crows = list(range(s0, s0 + sum(plan.rows_per)))
    else:
        crows = [s0 + 4 * c + f for f in range(4) for c in range(plan.ncon)]
    idx = list(range(s0)) + [inert] * plan.npad + crows
    idx = torch.as_tensor(idx, device=efc.J.device)

    def rows(t, fill):
        pad = torch.full_like(t[:, :1], fill)
        return torch.cat([t, pad], dim=1)[:, idx]

    return (rows(efc.J, 0.0), rows(efc.aref, 0.0), rows(efc.D, 1.0),
            rows(efc.R, 1.0), rows(efc.floss, 0.0),
            rows(efc.active, False))


def newton_problem(model: Model, data: Data):
    """The fused kernel's Newton problem of `data`, in plain PyTorch: (the
    Data with its smooth stage, (J, M, aref, D, R, floss, active, asm) in
    the fused row layout, the elliptic contacts' tables or None),
    `hopper_newton.newton_plain`'s operands and its `ell`."""
    from . import forward as fwd

    plan = model.plan
    if plan.smooth:
        d = kinematics.com_pos(model, data)
        d = inertia.factor_m(model, inertia.crb(model, d))
        d = fwd.fwd_acceleration(model, fwd.fwd_actuation(
            model, fwd.fwd_velocity(model, d)))
    else:  # cdof, cinert and qfrc_smooth come with the data
        d = inertia.factor_m(model, inertia.crb(model, data))
        d = d.replace(qacc_smooth=inertia.solve_m(model, d, d.qfrc_smooth))
    efc = con_mod.make_constraint(model, d)
    J, aref, D, R, floss, active = fused_rows(plan, efc)
    ell = None
    if plan.elliptic and plan.ell_runs:
        on = plan.con_dim >= 3
        ell = hn.ell_tables(plan.con_efcadr[on], plan.con_dim[on],
                            efc.con_mu, plan.nrows, J.device)
    return d, (J, d.qM, aref, D, R, floss, active.to(J.dtype),
               d.qacc_smooth), ell


def fused_constraint_plain(model: Model, data: Data, replay=None,
                           solve64=False, record=None) -> Data:
    """Plain version of `fused_constraint` (see the module note), on any
    device; `replay` = (iters, taken[, ls[, rows]]) and `record` (a dict
    for the solve's decisions, its own row decisions among them) as in
    `hopper_newton.newton_plain`. `solve64`: the Newton solve in float64 on
    the widened float32 problem, its qacc and forces rounded once (the
    mega kernels' solve for elliptic plans)."""
    from . import forward as fwd

    plan = model.plan
    damping_rows(plan, data)
    d, problem, ell = newton_problem(model, data)
    J, active = problem[0], problem[6]
    ws = d.qacc_warmstart
    if solve64:
        problem = tuple(t.double() for t in problem)
        ws = ws.double()
        if ell is not None:
            ell = (ell[0], ell[1].double(), ell[2].double(), ell[3])
    rec = {} if record is None else record
    x, force, iters, taken = hn.newton_plain(
        *problem, ws, ne=plan.ne, nfl=plan.nfl, iterations=plan.iterations,
        ls_iterations=plan.ls_iterations, scale=plan.scale,
        tol=plan.tolerance, replay=replay, ell=ell, record=rec)
    x, force = x.to(J.dtype), force.to(J.dtype)
    qfrc = torch.einsum("erv,er->ev", J * active[..., None], force)
    dv = fwd.damping_dv(model, d.replace(qacc=x)) if plan.euler_dv else None
    return _finish(model, data, x, force, qfrc, d.qacc_smooth, dv, iters,
                   taken, rec["ls"], rec["rows"])
