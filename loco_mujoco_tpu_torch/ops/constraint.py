"""Constraint assembly: JOINT equalities, dof friction loss, joint limits and
pyramidal or elliptic contacts.

Counterpart of `loco_mujoco_tpu/ops/constraint.py` (mj_makeConstraint) in
the staged row order the Newton solve relies on (`solver.row_class_counts`):
equality rows, then friction-loss rows, then limits, then the contact rows
of each slot in slot order: 2 (dim - 1) pyramidal facets, or, with
elliptic cones, dim rows (normal, tangents, then torsion and rolling from
the angular Jacobian; `:420-460`) whose friction rows carry the
impratio-scaled R, with the per-contact bookkeeping (`ell_start`,
`ell_dim`, `con_mu` = friction0 / sqrt(impratio)) the cone zones of the
solve read. Every potential row always exists and carries an active flag,
so shapes are static; all tensors carry a leading env axis E.
Non-JOINT equalities are refused at load. The invweights and the friction
loss are each env's where they vary per env (`Model.varied`); the
contacts' parameters come per slot from the collision stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import ConeType, Data, DisableBit, Model
from . import support
from .support import leaf

MINVAL = 1e-15
MINIMP = 0.0001
MAXIMP = 0.9999

EQUALITY = 0
FRICTION_DOF = 1
LIMIT_JOINT = 3
CONTACT_FRICTIONLESS = 5
CONTACT_PYRAMIDAL = 6
CONTACT_ELLIPTIC = 7


@dataclasses.dataclass(frozen=True)
class Efc:
    """Fixed-shape constraint rows of E envs."""

    J: torch.Tensor  # (E, nefc, nv)
    pos: torch.Tensor  # (E, nefc)
    aref: torch.Tensor
    R: torch.Tensor
    D: torch.Tensor
    floss: torch.Tensor  # friction-loss bound (friction rows only)
    active: torch.Tensor  # bool
    type: np.ndarray  # (nefc,) static row classes
    is_fl: np.ndarray
    is_bilateral: np.ndarray
    con_efcadr: np.ndarray  # contact slot -> first row, -1 if none
    con_dim: np.ndarray
    # elliptic contacts (empty for pyramidal models): first row and dim of
    # each, and its cone coefficient friction0 / sqrt(impratio), (E, n)
    ell_start: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    ell_dim: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    con_mu: torch.Tensor | None = None


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Constraint impedance d(pos): MuJoCo's sigmoid in |pos| / width."""
    dmin = torch.clamp(solimp[..., 0], MINIMP, MAXIMP)
    dmax = torch.clamp(solimp[..., 1], MINIMP, MAXIMP)
    width = solimp[..., 2]
    mid = torch.clamp(solimp[..., 3], MINIMP, MAXIMP)
    power = torch.clamp(solimp[..., 4], min=1.0)
    x = torch.clamp(pos.abs() / torch.clamp(width, min=MINVAL), 0.0, 1.0)
    lo = torch.pow(x, power) / torch.pow(mid, power - 1.0)
    hi = 1.0 - torch.pow(1.0 - x, power) / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x < mid, lo, hi)
    return torch.clamp(dmin + y * (dmax - dmin), MINIMP, MAXIMP)


def kbi(model: Model, solref, solimp, pos):
    """(k, b, imp): stiffness, damping and impedance of the constraint."""
    imp = impedance(solimp, pos)
    dmax = torch.clamp(solimp[..., 1], MINIMP, MAXIMP)
    timeconst = solref[..., 0]
    dampratio = solref[..., 1]
    if not (model.opt.disableflags & DisableBit.REFSAFE):
        timeconst = torch.maximum(timeconst, 2.0 * model.opt.timestep)
    k_std = 1.0 / torch.clamp(
        dmax * dmax * timeconst * timeconst * dampratio * dampratio,
        min=MINVAL)
    b_std = 2.0 / torch.clamp(dmax * timeconst, min=MINVAL)
    direct = (solref[..., 0] <= 0) | (solref[..., 1] <= 0)
    k = torch.where(direct,
                    -solref[..., 0] / torch.clamp(dmax * dmax, min=MINVAL),
                    k_std)
    b = torch.where(direct, -solref[..., 1] / torch.clamp(dmax, min=MINVAL),
                    b_std)
    return k, b, imp


def _r_of(imp, invweight):
    return torch.clamp((1.0 - imp) / torch.clamp(imp, min=MINVAL) * invweight,
                       min=MINVAL)


def make_constraint(model: Model, data: Data) -> Efc:
    qpos, qvel = data.qpos, data.qvel
    E, nv = qpos.shape[0], model.nv
    dt, dev = qpos.dtype, qpos.device
    flags = model.opt.disableflags
    disabled = bool(flags & DisableBit.CONSTRAINT)

    # blocks of (J, pos, aref, R, floss, active), in row order
    blocks, types = [], []
    dof_iw = leaf(model, "dof_invweight0")

    def one_hot(rows, cols):
        oh = np.zeros((len(rows), nv))
        oh[np.arange(len(rows)), cols] = 1.0
        return torch.as_tensor(oh, dtype=dt, device=dev)

    def zeros(n):
        return torch.zeros((E, n), dtype=dt, device=dev)

    def ones_b(n):
        return torch.ones((E, n), dtype=torch.bool, device=dev)

    # ---- JOINT equalities (one block) --------------------------------------
    if not (flags & DisableBit.EQUALITY) and not disabled:
        ids = np.nonzero(np.asarray(model.eq_active0, dtype=bool))[0]
        if len(ids):
            j1 = model.eq_obj1id[ids]
            j2r = model.eq_obj2id[ids]
            valid2 = (j2r >= 0) & (j2r < model.njnt) & (j2r != j1)
            q1, v1 = model.jnt_qposadr[j1], model.jnt_dofadr[j1]
            j2s = np.where(valid2, j2r, j1)
            q2, v2 = model.jnt_qposadr[j2s], model.jnt_dofadr[j2s]
            m2 = torch.as_tensor(valid2, dtype=dt, device=dev)
            dat = model.eq_data[ids]
            dif = m2 * (qpos[:, q2] - model.qpos0[q2])
            poly = (dat[:, 0] + dat[:, 1] * dif + dat[:, 2] * dif ** 2
                    + dat[:, 3] * dif ** 3 + dat[:, 4] * dif ** 4)
            dpoly = (dat[:, 1] + 2 * dat[:, 2] * dif + 3 * dat[:, 3] * dif ** 2
                     + 4 * dat[:, 4] * dif ** 3)
            pos = qpos[:, q1] - model.qpos0[q1] - poly
            jblk = one_hot(ids, v1) - (dpoly * m2)[..., None] * one_hot(ids, v2)
            iw = dof_iw[:, v1] + m2 * dof_iw[:, v2]
            k, b, imp = kbi(model, model.eq_solref[ids], model.eq_solimp[ids],
                            pos)
            vel = torch.einsum("erv,ev->er", jblk, qvel)
            aref = -b * vel - k * imp * pos
            blocks.append((jblk, pos, aref, _r_of(imp, iw), zeros(len(ids)),
                           ones_b(len(ids))))
            types += [EQUALITY] * len(ids)

    # ---- dof friction loss (one block) -------------------------------------
    if not (flags & DisableBit.FRICTIONLOSS) and not disabled:
        fl = np.nonzero(model.dof_frictionloss0 > 0)[0]
        if len(fl):
            zero_pos = zeros(len(fl))
            k, b, imp = kbi(model, model.dof_solref[fl], model.dof_solimp[fl],
                            zero_pos)
            aref = -b * qvel[:, fl]
            r = _r_of(imp, dof_iw[:, fl])
            blocks.append((one_hot(fl, fl).expand(E, -1, -1), zero_pos, aref,
                           r, leaf(model, "dof_frictionloss")[:, fl].expand(
                               E, -1), ones_b(len(fl))))
            types += [FRICTION_DOF] * len(fl)

    # ---- joint limits (one block) ------------------------------------------
    if not (flags & DisableBit.LIMIT) and not disabled:
        lim = np.nonzero(model.jnt_limited)[0]
        if len(lim):
            q, v = model.jnt_qposadr[lim], model.jnt_dofadr[lim]
            dist_lo = qpos[:, q] - model.jnt_range[lim, 0]
            dist_hi = model.jnt_range[lim, 1] - qpos[:, q]
            use_lo = dist_lo <= dist_hi
            dist = torch.where(use_lo, dist_lo, dist_hi)
            sign = torch.where(use_lo, 1.0, -1.0).to(dt)
            jblk = one_hot(lim, v) * sign[..., None]
            margin = model.jnt_margin[lim]
            pos = dist - margin
            k, b, imp = kbi(model, model.jnt_solref[lim],
                            model.jnt_solimp[lim], pos)
            aref = -b * (sign * qvel[:, v]) - k * imp * pos
            blocks.append((jblk, pos, aref, _r_of(imp, dof_iw[:, v]),
                           zeros(len(lim)), dist < margin))
            types += [LIMIT_JOINT] * len(lim)

    # ---- contacts: contiguous runs of equal condim ------------------------
    con = data.contact
    ncon = model.ncon
    con_efcadr = np.full(ncon, -1, dtype=np.int32)
    con_dim = np.zeros(ncon, dtype=np.int32)
    elliptic = model.opt.cone == int(ConeType.ELLIPTIC)
    ell_start, ell_dim, con_mu = [], [], []
    if ncon and not (flags & DisableBit.CONTACT) and not disabled:
        gb = torch.as_tensor(model.geom_bodyid, device=dev, dtype=torch.int64)
        runs, start = [], 0
        for c in range(1, ncon + 1):
            if c == ncon or con.dim[c] != con.dim[start]:
                runs.append((start, c - start, int(con.dim[start])))
                start = c
        cursor = len(types)
        for s0, cnt, dim in runs:
            sl = slice(s0, s0 + cnt)
            b1, b2 = gb[con.geom1[:, sl]], gb[con.geom2[:, sl]]
            pos_c = con.dist[:, sl] - con.includemargin[:, sl]
            active = con.dist[:, sl] < con.includemargin[:, sl]
            jacp1, jacr1 = support.jac_dyn(model, data, con.pos[:, sl], b1)
            jacp2, jacr2 = support.jac_dyn(model, data, con.pos[:, sl], b2)
            jp = jacp2 - jacp1  # (E, cnt, 3, nv)
            frame = con.frame[:, sl]
            iw_t = (support.pick(model, "body_invweight0", b1)[..., 0]
                    + support.pick(model, "body_invweight0", b2)[..., 0])
            mu = con.friction[:, sl, 0]
            k, b_, imp = kbi(model, con.solref[:, sl], con.solimp[:, sl],
                             pos_c)
            # frame rows times the Jacobians: translational for rows 0-2,
            # rotational (frame row t - 3) for torsion and rolling
            axis_rows = [torch.einsum("eci,eciv->ecv", frame[:, :, t], jp)
                         for t in range(min(dim, 3))]
            if dim > 3:
                jr = jacr2 - jacr1
                axis_rows += [torch.einsum("eci,eciv->ecv", frame[:, :, t],
                                           jr) for t in range(dim - 3)]
            nr = 1 if dim == 1 else (dim if elliptic else 2 * (dim - 1))
            con_efcadr[s0:s0 + cnt] = cursor + nr * np.arange(cnt)
            con_dim[s0:s0 + cnt] = dim
            if dim == 1:
                jblk = axis_rows[0]
                r = _r_of(imp, iw_t)
                typ = CONTACT_FRICTIONLESS
            elif elliptic:
                # normal row, then the friction rows with
                # R = Rn mu0^2 / (mu_i^2 impratio)
                jblk = torch.stack(axis_rows, dim=2).reshape(E, cnt * nr, nv)
                r_n = _r_of(imp, iw_t)
                mus = con.friction[:, sl, :dim - 1]
                r_f = torch.clamp(r_n[..., None] * (mu * mu)[..., None]
                                  / (mus * mus) / model.opt.impratio,
                                  min=MINVAL)
                r = torch.cat([r_n[..., None], r_f], dim=-1).reshape(E, -1)
                ell_start.extend(cursor + nr * np.arange(cnt))
                ell_dim.extend([dim] * cnt)
                con_mu.append(mu / torch.sqrt(model.opt.impratio))
                vel = torch.einsum("erv,ev->er", jblk, qvel)
                kimp = torch.zeros((E, cnt, nr), dtype=dt, device=dev)
                kimp[..., 0] = k * imp * pos_c
                aref = -torch.repeat_interleave(b_, nr, dim=1) * vel \
                    - kimp.reshape(E, -1)
                rep = lambda x: torch.repeat_interleave(x, nr, dim=1)  # noqa
                blocks.append((jblk, rep(pos_c), aref, r, zeros(cnt * nr),
                               rep(active)))
                types += [CONTACT_ELLIPTIC] * (cnt * nr)
                cursor += cnt * nr
                continue
            else:
                # pyramidal facets J = Jn +- mu_i Jt_i, all with
                # R = Rn * 2 mu0^2 (1 + mu0^2)
                r = _r_of(imp, iw_t * 2.0 * mu * mu * (1.0 + mu * mu))
                rows = []
                for t in range(1, dim):
                    mu_i = con.friction[:, sl, t - 1][..., None]
                    for s in (1.0, -1.0):
                        rows.append(axis_rows[0] + s * mu_i * axis_rows[t])
                jblk = torch.stack(rows, dim=2).reshape(E, cnt * nr, nv)
                typ = CONTACT_PYRAMIDAL
            rep = lambda x: torch.repeat_interleave(x, nr, dim=1)
            vel = torch.einsum("erv,ev->er", jblk, qvel)
            aref = -rep(b_) * vel - rep(k * imp * pos_c)
            blocks.append((jblk, rep(pos_c), aref, rep(r),
                           zeros(cnt * nr), rep(active)))
            types += [typ] * (cnt * nr)
            cursor += cnt * nr

    type_arr = np.asarray(types, dtype=np.int32)
    ell = dict(ell_start=np.asarray(ell_start, np.int32),
               ell_dim=np.asarray(ell_dim, np.int32),
               con_mu=torch.cat(con_mu, dim=1) if con_mu else None)
    if not blocks:
        z = zeros(0)
        return Efc(J=torch.zeros((E, 0, nv), dtype=dt, device=dev), pos=z,
                   aref=z, R=z, D=z, floss=z,
                   active=torch.zeros((E, 0), dtype=torch.bool, device=dev),
                   type=type_arr, is_fl=type_arr == FRICTION_DOF,
                   is_bilateral=type_arr == EQUALITY, con_efcadr=con_efcadr,
                   con_dim=con_dim, **ell)
    J, pos, aref, R, floss, active = (
        torch.cat([blk[i].expand(E, *blk[i].shape[-(2 if i == 0 else 1):])
                   for blk in blocks], dim=1)
        for i in range(6))
    return Efc(J=J, pos=pos, aref=aref, R=R, D=1.0 / R, floss=floss,
               active=active, type=type_arr, is_fl=type_arr == FRICTION_DOF,
               is_bilateral=type_arr == EQUALITY, con_efcadr=con_efcadr,
               con_dim=con_dim, **ell)
