"""Collision: static pair table -> per-group top-K -> analytic narrowphase.

Counterpart of `loco_mujoco_tpu/ops/collision.py` for every classic pair
kind of its `SLOTS` table (`:39-49`): plane against sphere, capsule,
cylinder, box and mesh, and the self pairs sphere-sphere, sphere-capsule,
sphere-box and capsule-capsule. The candidate pairs are split at load into
groups keyed by (geom-type pair, condim); each group fills k * slots
contact slots, in the same slot layout as the reference. Plane groups rank
their pairs by the exact support distance of the second geom, self groups
by centre distance minus the static bounding radii (`_rbound`, `:838`),
both minus the pair margin, first index on ties (`lax.top_k`'s order); the
narrowphase then runs on the k selected pairs. A plane-mesh group either
runs the Hopper kernel `hopper_collision.mesh_slots` (gated at load like
the reference's Pallas path) or the port of the XLA narrowphase
(`_plane_mesh_xla`), which is the numerical reference and the float64 path.

Convex pairs (`CONVEX_SLOTS`, GJK/EPA in the reference) sort after every
classic group. In float32 the reference emits their slots inactive (`:870`,
the convex-tail truncation `classic_ncon`, which the row plan sizes to), and
so does the port; a float64 model with such pairs is refused at load
(`core/io.py`), since GJK is not ported. Other pair kinds raise
`NotImplementedError` at load.

Geom sizes, bounding radii, hull vertices and pair parameters are each
env's where they vary per env (`Model.varied`: stacked variants, domain
randomization of the Geoms friction): the plane-mesh kernel reads each
env's variant's hull table, and per-env pair parameters are gathered by
the slots' pairs after it (`_plane_mesh_kernel`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Contact, Data, GeomType, Model
from . import hopper_collision as hc
from . import math as m3
from .support import cached, leaf, pick

_PLANE = int(GeomType.PLANE)
_SPHERE = int(GeomType.SPHERE)
_CAPSULE = int(GeomType.CAPSULE)
_CYLINDER = int(GeomType.CYLINDER)
_BOX = int(GeomType.BOX)
_MESH = int(GeomType.MESH)

# contacts per pair of each analytic narrowphase (the reference's SLOTS)
SLOTS = {
    (_PLANE, _SPHERE): 1,
    (_PLANE, _CAPSULE): 2,
    (_PLANE, _CYLINDER): 4,
    (_PLANE, _BOX): 4,
    (_PLANE, _MESH): 3,
    (_SPHERE, _SPHERE): 1,
    (_SPHERE, _CAPSULE): 1,
    (_SPHERE, _BOX): 1,
    (_CAPSULE, _CAPSULE): 2,
}
# convex pairs, one slot each (GJK/EPA in the reference; inactive here)
CONVEX_SLOTS = {
    (_SPHERE, _CYLINDER), (_SPHERE, _MESH), (_CAPSULE, _CYLINDER),
    (_CAPSULE, _BOX), (_CAPSULE, _MESH), (_CYLINDER, _CYLINDER),
    (_CYLINDER, _BOX), (_CYLINDER, _MESH), (_BOX, _BOX), (_BOX, _MESH),
    (_MESH, _MESH),
}

BIG = 1e10


class Group(NamedTuple):
    t1: int
    t2: int
    condim: int
    pair_ids: np.ndarray  # indices into the model's pair tables
    k: int
    slots: int
    offset: int  # first contact slot of this group
    convex: bool = False  # a GJK group of the slot layout's tail


def contact_groups(pair_geom1, pair_geom2, pair_condim, geom_type,
                   k_plane: int, k_other: int):
    """(groups, total slots) of the static pair table, in the reference's
    order: classic groups sorted by (t1, t2, condim), k = min(budget,
    pairs), then the convex groups (k = min(k_other, pairs), one slot
    each)."""
    by_key: dict = {}
    conv_key: dict = {}
    for i in range(len(pair_geom1)):
        t1 = int(geom_type[pair_geom1[i]])
        t2 = int(geom_type[pair_geom2[i]])
        key = (t1, t2, int(pair_condim[i]))
        if (t1, t2) in SLOTS:
            by_key.setdefault(key, []).append(i)
        elif (t1, t2) in CONVEX_SLOTS or (t2, t1) in CONVEX_SLOTS:
            conv_key.setdefault(key, []).append(i)
        else:
            raise NotImplementedError(
                f"contact pair kind {(t1, t2)} is not ported")
    groups, offset = [], 0
    for (t1, t2, condim), ids in sorted(by_key.items()):
        k = min(k_plane if t1 == _PLANE else k_other, len(ids))
        slots = SLOTS[(t1, t2)]
        groups.append(Group(t1, t2, condim, np.asarray(ids, np.int32), k,
                            slots, offset))
        offset += k * slots
    for (t1, t2, condim), ids in sorted(conv_key.items()):
        k = min(k_other, len(ids))
        groups.append(Group(t1, t2, condim, np.asarray(ids, np.int32), k, 1,
                            offset, convex=True))
        offset += k
    return groups, offset


def classic_ncon(groups, total: int) -> int:
    """Slots of the classic (analytic) groups: the convex groups sit at the
    layout's tail, so this is the first convex offset (`:158`)."""
    return next((g.offset for g in groups if g.convex), total)


def is_plane_mesh(g: Group) -> bool:
    return g.t1 == _PLANE and g.t2 == _MESH


def _topk_first(key: torch.Tensor, k: int) -> torch.Tensor:
    """(E, k) indices of the k smallest keys, first index on ties (the
    reference's iterative argmin / lax.top_k order)."""
    return torch.argsort(key, dim=1, stable=True)[:, :k]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


# --------------------------------------------------------------------------
# narrowphase: plane-X (the plane is geom 1, its normal the plane's z axis).
# Every function takes the selected pairs' poses, pp/qp (E, k, 3), pR/qR
# (E, k, 3, 3), sizes s1/s2 (E, k, 3), and returns dist (E, k, S),
# pos (E, k, S, 3), frame (E, k, S, 3, 3) of its S slots per pair.
# --------------------------------------------------------------------------


def plane_sphere(pp, pR, s1, qp, qR, s2):
    n = pR[..., 2]
    r = s2[..., 0]
    dist = _dot(n, qp - pp) - r
    pos = qp - n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], m3.make_frame(n)[..., None, :, :]


def _frame_with_axis(n, axis):
    """Contact frame whose first tangent is `axis` projected into the plane
    of the normal (mjc_PlaneCapsule's convention); make_frame where the
    axis is parallel to the normal."""
    t1 = axis - n * _dot(n, axis)[..., None]
    ln = _norm(t1)
    ok = ln > 1e-8
    t1 = torch.where(ok[..., None], t1 / torch.clamp(ln, min=1e-15)[..., None],
                     torch.zeros_like(t1))
    f_axis = torch.stack([n, t1, m3.cross(n, t1)], dim=-2)
    return torch.where(ok[..., None, None], f_axis, m3.make_frame(n))


def plane_capsule(pp, pR, s1, qp, qR, s2):
    n = pR[..., 2]
    r, hl = s2[..., 0], s2[..., 1]
    axis = qR[..., 2]
    frame = _frame_with_axis(n, axis)
    ds, ps = [], []
    for sgn in (1.0, -1.0):
        c = qp + (sgn * hl)[..., None] * axis
        dist = _dot(n, c - pp) - r
        ds.append(dist)
        ps.append(c - n * (r + 0.5 * dist)[..., None])
    return (torch.stack(ds, dim=-1), torch.stack(ps, dim=-2),
            torch.stack([frame, frame], dim=-3))


def plane_cylinder(pp, pR, s1, qp, qR, s2):
    """Four candidate contacts (mjc_PlaneCylinder's sets): the deepest rim
    point of the lower cap, the two rim points at +-120 degrees on it, and
    the deepest rim point of the upper cap."""
    n = pR[..., 2]
    r, hl = s2[..., 0], s2[..., 1]
    axis = qR[..., 2]
    ca = _dot(n, axis)
    sgn = torch.where(ca >= 0, -1.0, 1.0).to(ca.dtype)  # toward the lower cap
    cap_near = qp + (sgn * hl)[..., None] * axis
    cap_far = qp - (sgn * hl)[..., None] * axis
    d = axis * ca[..., None] - n
    dn = _norm(d)
    d = torch.where((dn > 1e-8)[..., None],
                    d / torch.clamp(dn, min=1e-15)[..., None], qR[..., 0])
    e = m3.cross(axis, d)
    e = e / torch.clamp(_norm(e), min=1e-15)[..., None]
    cos120, sin120 = -0.5, float(np.sqrt(3.0) / 2.0)
    rr = r[..., None]
    pts = [cap_near + rr * d, cap_near + rr * (cos120 * d + sin120 * e),
           cap_near + rr * (cos120 * d - sin120 * e), cap_far + rr * d]
    ds = [_dot(n, p - pp) for p in pts]
    ps = [p - n * (0.5 * h)[..., None] for p, h in zip(pts, ds)]
    frame = m3.make_frame(n)[..., None, :, :]
    return (torch.stack(ds, dim=-1), torch.stack(ps, dim=-2),
            frame.expand(*frame.shape[:-3], 4, 3, 3))


def plane_box(pp, pR, s1, qp, qR, s2):
    """Four deepest box corners against the plane."""
    dt, dev = pp.dtype, pp.device
    n = pR[..., 2]
    corners = torch.tensor(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=dt, device=dev)
    pts = qp[:, :, None] + torch.einsum("ekij,cj,ekj->ekci", qR, corners, s2)
    h = torch.sum(n[:, :, None] * (pts - pp[:, :, None]), dim=-1)  # (E,k,8)
    hm, hs, ps = h, [], []
    for _ in range(4):
        d, i = hc.first_argmin(hm, 2)
        hs.append(d)
        ps.append(torch.gather(pts, 2, i[..., None, None].expand(-1, -1, 1, 3))
                  [:, :, 0])
        hm = hm.scatter(2, i[..., None], BIG)
    dist = torch.stack(hs, dim=2)
    pos = torch.stack(ps, dim=2) - n[:, :, None] * (0.5 * dist)[..., None]
    frame = m3.make_frame(n)[:, :, None].expand(-1, -1, 4, -1, -1)
    return dist, pos, frame


# --------------------------------------------------------------------------
# narrowphase: self pairs
# --------------------------------------------------------------------------


def _sphere_sphere_core(c1, r1, c2, r2):
    d = c2 - c1
    ln = _norm(d)
    n = d / torch.clamp(ln, min=1e-15)[..., None]
    dist = ln - r1 - r2
    pos = 0.5 * (c1 + n * r1[..., None] + c2 - n * r2[..., None])
    return dist, pos, m3.make_frame(n)


def _one_slot(dist, pos, frame):
    return dist[..., None], pos[..., None, :], frame[..., None, :, :]


def sphere_sphere(pp, pR, s1, qp, qR, s2):
    return _one_slot(*_sphere_sphere_core(pp, s1[..., 0], qp, s2[..., 0]))


def sphere_capsule(pp, pR, s1, qp, qR, s2):
    axis = qR[..., 2]
    hl = s2[..., 1]
    t = torch.minimum(torch.maximum(_dot(pp - qp, axis), -hl), hl)
    c2 = qp + t[..., None] * axis
    return _one_slot(*_sphere_sphere_core(pp, s1[..., 0], c2, s2[..., 0]))


def _seg_seg_closest(p1, d1, l1, p2, d2, l2):
    """Closest points of the segments p +- l d (centred parameters)."""
    def clip(x, lim):
        return torch.minimum(torch.maximum(x, -lim), lim)

    r = p1 - p2
    a, e = _dot(d1, d1), _dot(d2, d2)
    f, c, b = _dot(d2, r), _dot(d1, r), _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom.abs() > 1e-12,
                    (b * f - c * e) / torch.clamp(denom, min=1e-15),
                    torch.zeros_like(denom))
    s = clip(s, l1)
    t = clip((b * s + f) / torch.clamp(e, min=1e-15), l2)
    s = clip((b * t - c) / torch.clamp(a, min=1e-15), l1)
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


def capsule_capsule(pp, pR, s1, qp, qR, s2):
    """One contact between the closest points of the axes; the second
    slot stays inactive (the reference's layout)."""
    c1, c2 = _seg_seg_closest(pp, pR[..., 2], s1[..., 1], qp, qR[..., 2],
                              s2[..., 1])
    dist, pos, frame = _sphere_sphere_core(c1, s1[..., 0], c2, s2[..., 0])
    return (torch.stack([dist, torch.full_like(dist, BIG)], dim=-1),
            torch.stack([pos, torch.zeros_like(pos)], dim=-2),
            torch.stack([frame, frame], dim=-3))


def sphere_box(pp, pR, s1, qp, qR, s2):
    """Sphere (geom 1) against a box (geom 2): the closest point on the
    box surface, or, with the centre inside, the nearest face (first axis
    on ties)."""
    r = s1[..., 0]
    loc = torch.einsum("ekji,ekj->eki", qR, pp - qp)  # centre, box frame
    clamped = torch.minimum(torch.maximum(loc, -s2), s2)
    inside = torch.all(loc.abs() < s2, dim=-1)
    _, ax = hc.first_argmin(s2 - loc.abs(), -1)
    face = torch.sign(loc) * s2
    onehot = torch.arange(3, device=loc.device) == ax[..., None]
    closest = torch.where(inside[..., None],
                          torch.where(onehot, face, loc), clamped)
    cw = qp + torch.einsum("ekij,ekj->eki", qR, closest)
    d = cw - pp
    ln = _norm(d)
    n_out = d / torch.clamp(ln, min=1e-15)[..., None]
    n = torch.where(inside[..., None], -n_out, n_out)
    dist = torch.where(inside, -(ln + r), ln - r)
    pos = 0.5 * (pp + n * r[..., None] + cw)
    return _one_slot(dist, pos, m3.make_frame(n))


NARROW = {
    (_PLANE, _SPHERE): plane_sphere,
    (_PLANE, _CAPSULE): plane_capsule,
    (_PLANE, _CYLINDER): plane_cylinder,
    (_PLANE, _BOX): plane_box,
    (_SPHERE, _SPHERE): sphere_sphere,
    (_SPHERE, _CAPSULE): sphere_capsule,
    (_SPHERE, _BOX): sphere_box,
    (_CAPSULE, _CAPSULE): capsule_capsule,
}


def rbound_of(size: torch.Tensor, geom_type) -> torch.Tensor:
    """(..., ngeom) static bounding radii of the self groups' midphase
    (`_rbound`: sphere r, capsule r + half length, cylinder hypot, box
    half diagonal; 0 for other types) from the geom sizes (..., ngeom,
    3)."""
    per_type = {_SPHERE: size[..., 0], _CAPSULE: size[..., 0] + size[..., 1],
                _CYLINDER: torch.sqrt(size[..., 0] ** 2 + size[..., 1] ** 2),
                _BOX: torch.sqrt(_dot(size, size))}
    out = torch.zeros_like(size[..., 0])
    gt = torch.as_tensor(np.asarray(geom_type), device=size.device)
    for t, v in per_type.items():
        out = torch.where(gt == t, v, out)
    return out


def rbound(model: Model) -> torch.Tensor:
    """(ngeom,) bounding radii, or (E, ngeom) each env's where geom_size
    varies per env."""
    return rbound_of(model.geom_size, model.geom_type)


def midphase_key(model: Model, g: Group, data: Data, pg1, pg2):
    """(E, P) ranking key of a group's pairs, minus the pair margin: the
    exact support distance along the plane normal for plane groups, the
    centre distance minus both bounding radii for self pairs."""
    gxp, gxm = data.geom_xpos, data.geom_xmat
    if g.t1 == _PLANE:
        n = gxm[:, pg1, :, 2]
        h = _dot(n, gxp[:, pg2] - gxp[:, pg1])
        sz = leaf(model, "geom_size")[:, pg2]
        if g.t2 == _SPHERE:
            supp = sz[..., 0].expand_as(h)
        elif g.t2 == _CAPSULE:
            ca = _dot(n, gxm[:, pg2, :, 2]).abs()
            supp = sz[..., 1] * ca + sz[..., 0]
        elif g.t2 == _CYLINDER:
            ca = _dot(n, gxm[:, pg2, :, 2]).abs()
            supp = sz[..., 1] * ca + sz[..., 0] * torch.sqrt(
                torch.clamp(1.0 - ca * ca, min=0.0))
        else:  # box
            proj = torch.einsum("eki,ekij->ekj", n, gxm[:, pg2]).abs()
            supp = torch.sum(proj * sz, dim=-1)
        mid = h - supp
    else:
        rb = rbound(model)
        mid = _norm(gxp[:, pg2] - gxp[:, pg1]) - rb[..., pg1] - rb[..., pg2]
    return mid - leaf(model, "pair_margin")[:, g.pair_ids]


def _analytic_group(model: Model, g: Group, data: Data):
    pid = g.pair_ids
    pg1, pg2 = model.pair_geom1[pid], model.pair_geom2[pid]
    gxp, gxm = data.geom_xpos, data.geom_xmat
    E, dev = gxp.shape[0], gxp.device
    if g.k < len(pid):
        sel = _topk_first(midphase_key(model, g, data, pg1, pg2), g.k)
    else:
        sel = torch.arange(len(pid), device=dev).expand(E, -1)
    pid_t = torch.as_tensor(pid, device=dev, dtype=torch.int64)
    sel_p = pid_t[sel]  # (E, k) pair ids
    sg1 = torch.as_tensor(model.pair_geom1, device=dev)[sel_p].long()
    sg2 = torch.as_tensor(model.pair_geom2, device=dev)[sel_p].long()
    d, p, f = NARROW[(g.t1, g.t2)](
        hc.take(gxp, sg1), hc.take(gxm, sg1), pick(model, "geom_size", sg1),
        hc.take(gxp, sg2), hc.take(gxm, sg2), pick(model, "geom_size", sg2))
    return (d, p, f, sg1, sg2, *_pair_statics(model, sel_p))


def _pair_statics(model: Model, sel_p: torch.Tensor) -> tuple:
    """friction, solref, solimp and margin - gap of the pairs `sel_p`
    (E, k), each env's where they vary per env."""
    marg = pick(model, "pair_margin", sel_p) - pick(model, "pair_gap", sel_p)
    return (pick(model, "pair_friction", sel_p),
            pick(model, "pair_solref", sel_p),
            pick(model, "pair_solimp", sel_p), marg)


def _convex_group(model: Model, g: Group, data: Data):
    """Inactive slots of a convex group in float32 (`:870-897`): the first
    k candidate pairs' ids and statics, depth 1e10."""
    E, dev = data.qpos.shape[0], data.qpos.device
    sel_p = torch.as_tensor(g.pair_ids[:g.k], device=dev,
                            dtype=torch.int64).expand(E, -1)
    dt = data.qpos.dtype
    eye = torch.eye(3, dtype=dt, device=dev).expand(E, g.k, 1, 3, 3)
    g1 = torch.as_tensor(model.pair_geom1, device=dev)[sel_p].long()
    g2 = torch.as_tensor(model.pair_geom2, device=dev)[sel_p].long()
    return (torch.full((E, g.k, 1), BIG, dtype=dt, device=dev),
            torch.zeros((E, g.k, 1, 3), dtype=dt, device=dev), eye, g1, g2,
            *_pair_statics(model, sel_p))


def _plane_mesh_narrow(model: Model, pid: np.ndarray, vcap: int,
                       data: Data):
    """Manifold selection for one bucket of plane-mesh pairs
    (`hopper_collision.manifold_plain`). Returns dist (E, P, 3), vsel
    (E, P, 3, 3) mesh-local, key (E, P)."""
    dev = data.qpos.device
    pg1, pg2 = model.pair_geom1[pid], model.pair_geom2[pid]
    mesh_ids = np.maximum(np.asarray(model.geom_meshid)[pg2], 0)
    vmask = torch.as_tensor(np.asarray(model.mesh_vertmask)[mesh_ids, :vcap],
                            device=dev)
    nbr = hc.graph_table(model.mesh_nbr, mesh_ids, vcap)
    if nbr is not None:
        nbr = torch.as_tensor(nbr, device=dev)
    a, b = hc.plane_in_mesh_frame(data.geom_xpos, data.geom_xmat, pg1, pg2)
    margin = leaf(model, "pair_margin")[:, pid]
    if "mesh_vert" in model.varied:  # each env's variant's hulls
        verts = model.mesh_vert[model.env_id[:, None],
                                torch.as_tensor(mesh_ids, device=dev)[None],
                                :vcap]
    else:
        verts = model.mesh_vert[mesh_ids, :vcap]
    dist, vsel = hc.manifold_plain(
        verts, vmask, nbr, np.asarray(model.mesh_brute)[mesh_ids], a, b,
        margin, (0.3 * leaf(model, "geom_rbound")[:, pg2]) ** 2)
    return dist, vsel, dist[..., 0] - margin


def _plane_mesh_xla(model: Model, g: Group, data: Data):
    """Port of the reference's XLA plane-mesh group: hull-size buckets,
    per-bucket manifolds, then exact-support top-K (identity order when
    k >= P: the reference's staged path, `collision.py:397-410`)."""
    pid = np.asarray(g.pair_ids)
    mesh_ids = np.maximum(np.asarray(model.geom_meshid), 0)
    counts = np.asarray(model.mesh_vertmask).sum(1)[
        mesh_ids[model.pair_geom2[pid]]]
    buckets = []
    for cap in (128, 288, int(np.asarray(model.mesh_vertmask).shape[1])):
        in_b = counts <= cap
        if np.any(in_b):
            buckets.append((cap, pid[in_b]))
            counts = np.where(in_b, np.iinfo(np.int64).max, counts)
    outs = [_plane_mesh_narrow(model, bpid, cap, data) for cap, bpid in buckets]
    dist = torch.cat([o[0] for o in outs], dim=1)  # (E, P, 3)
    vsel = torch.cat([o[1] for o in outs], dim=1)  # (E, P, 3, 3)
    key = torch.cat([o[2] for o in outs], dim=1)  # (E, P)
    pid = np.concatenate([bpid for _, bpid in buckets])

    pg1, pg2 = model.pair_geom1[pid], model.pair_geom2[pid]
    gxp, gxm = data.geom_xpos, data.geom_xmat
    dev = key.device
    sel, dist_s, pos, frame = hc.pair_topk(
        key, g.k, dist, vsel, gxm[:, pg1, :, 2], gxp[:, pg2], gxm[:, pg2])
    sel_p = torch.as_tensor(pid, device=dev, dtype=torch.int64)[sel]
    frame = frame[:, :, None].expand(-1, -1, g.slots, -1, -1)
    g1 = torch.as_tensor(model.pair_geom1, device=dev)[sel_p].long()
    g2 = torch.as_tensor(model.pair_geom2, device=dev)[sel_p].long()
    return (dist_s, pos, frame, g1, g2, *_pair_statics(model, sel_p))


_PAIR_STATICS = ("pair_friction", "pair_solref", "pair_solimp",
                 "pair_margin", "pair_gap")


def pair_of_geoms(model: Model, g: Group) -> torch.Tensor:
    """(ngeom, ngeom) int64: the model's pair id of each (plane geom, mesh
    geom) of plane-mesh group `g`, on the model's device (made once). A
    group that holds one geom pair twice raises: its slots' pair would be
    ambiguous."""
    def build():
        t = np.zeros((model.ngeom, model.ngeom), np.int64)
        seen = set()
        for p in g.pair_ids:
            key = (int(model.pair_geom1[p]), int(model.pair_geom2[p]))
            if key in seen:
                raise NotImplementedError(
                    f"plane-mesh group with the geom pair {key} twice: "
                    f"per-env pair parameters need one pair per geoms")
            seen.add(key)
            t[key] = int(p)
        return torch.as_tensor(t, device=model.qpos0.device)

    return cached(model, ("pair_of_geoms", int(g.offset),
                          str(model.qpos0.device)), build)


def _plane_mesh_kernel(model: Model, g: Group, plan: hc.MeshPlan,
                       data: Data, plain: bool):
    """The kernel path: one launch of `hopper_collision.mesh_slots` on the
    geom poses as Data holds them (or its plain version), with each env's
    hull table where the plan holds one per variant, its per-pair frame
    given to each of the pair's slots. Where the pair parameters vary per
    env (domain randomization of the Geoms friction), each slot's are
    gathered after the launch by its pair, found from its geoms (an
    inactive rank holds pair 0's geoms, and so gets pair 0's, as the
    kernel gives it)."""
    slots = hc.mesh_slots_plain if plain else hc.mesh_slots
    ds, pos, fr, g1, g2, *rest = slots(plan, data.geom_xpos, data.geom_xmat,
                                       env_id=model.env_id)
    if model.varied & set(_PAIR_STATICS):
        rest = list(_pair_statics(model, pair_of_geoms(model, g)[g1, g2]))
    return (ds, pos, fr[:, :, None].expand(-1, -1, g.slots, -1, -1), g1, g2,
            *rest)


def collision(model: Model, data: Data, plain: bool = False,
              ranked: bool = False) -> Data:
    """Fill every contact slot. plain=True runs the plane-mesh kernel's
    plain version on any device (the reference it is held to).
    ranked=True, with plain, lays the slots out as the mega kernels do
    (their plain version's collision): a plane-mesh group at k = P, which
    the staged path keeps in pair order, ranks its pairs on the mega
    plan's hull tables (`RowPlan.mesh`), deepest first."""
    if model.ncon == 0:
        return data
    parts = []
    for g, plan in zip(model.groups, model.mesh_kernel):
        if g.convex:
            out = _convex_group(model, g, data)
        elif is_plane_mesh(g):
            if plan is None and ranked and model.plan is not None:
                plan = model.plan.mesh  # a mega plan holds one such group
            # float64 on the CPU keeps the XLA port; a CUDA tensor always
            # takes the kernel, which raises unless it is float32
            if plan is not None and (data.qpos.is_cuda
                                     or data.qpos.dtype == torch.float32):
                out = _plane_mesh_kernel(model, g, plan, data, plain)
            else:
                out = _plane_mesh_xla(model, g, data)
        else:
            out = _analytic_group(model, g, data)
        parts.append((g, out))

    E = data.qpos.shape[0]

    def cat(idx, tail):
        return torch.cat([
            o[idx].reshape(E, g.k * g.slots, *tail) if idx < 3 else
            torch.repeat_interleave(o[idx], g.slots, dim=1)
            for g, o in parts], dim=1)

    contact = Contact(
        dist=cat(0, ()), pos=cat(1, (3,)), frame=cat(2, (3, 3)),
        geom1=cat(3, ()), geom2=cat(4, ()), friction=cat(5, ()),
        solref=cat(6, ()), solimp=cat(7, ()), includemargin=cat(8, ()),
        dim=np.concatenate([np.full(g.k * g.slots, g.condim, np.int32)
                            for g, _ in parts]),
    )
    return data.replace(contact=contact)
