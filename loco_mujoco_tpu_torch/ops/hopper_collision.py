"""Plane-mesh contact selection on the card: manifold select and group top-K.

Counterpart of `loco_mujoco_tpu/ops/pallas_collision.py`: `_make_kernel` /
`_select_batched_raw` (the per-pair manifold select) and
`_topk_kernel_builder` / `make_group_topk` (the per-env top-K slot pick),
here the CUDA kernels of `csrc/plane_mesh.cu`. The static tables come from
this module's own numpy copy of `pack_plane_mesh_buckets`.

`mesh_tables` builds, once at model load, a plane-mesh group's hull tables
and bucket order at any budget k, or None where the reference's packing
refuses the group (a graph-less hull, a hull past the vertex cap); the
mega plans (`ops/plan.py`) take them at any k, k = P too, as the
reference's do (`pallas_fk.py:449-458`). `staged_plan` is the reference's
static gate of these kernels on the staged path: a group runs them only
if it has more pairs than slots (k < P). With k >= P the reference's
staged XLA path keeps its pairs in order (`collision.py:397-410`, its
`_pallas_group_topk_fn` stepping aside at `:438-442`), and so does the
port's (`collision._plane_mesh_xla`); its mega kernels rank them all
(`pallas_fk._mesh_group_slots`, `:825-850`), and so do the port's and their
plain version (`pair_topk(ranked=True)`). The kernels take float32 only: a
CUDA tensor of another dtype raises, and float64 on the CPU keeps the XLA
port.

Operands are env-last: a (P, 3, E), b (P, E) -> dist (P, 3, E), vsel
(P, 9, E); the top-K reads those plus the poses of the geoms the group uses,
gxp (G, 3, E) and gxm (G, 9, E), and writes dist (k, 3, E), pos (k, 9, E),
frame (k, 9, E), meta (k, 15, E) = [geom1, geom2, friction(5), solref(2),
solimp(5), margin - gap]. A CUDA tensor launches the kernel or raises; a
CPU tensor takes the plain version (`select_plain`, `group_topk_plain`).
The plain versions are env-last relayouts of `manifold_plain` and
`pair_topk`, the ports of the reference's XLA narrowphase
(`collision._plane_mesh_narrow`) and of the XLA branch of its
`_plane_mesh_group`, which `collision.py` runs as its XLA path too. They
differ from the kernels only where no contact is: the kernels write the
conservative bound as the depth of a pair that cannot reach the margin,
and vertex 0 where a pair has no manifold.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from . import kernels
from . import math as m3
from .kernels import INT, PTR

BIG = 1e10
MESH_VCAP = 5632  # largest bucket the kernels take (pallas_collision.py:333)

_SIGNATURES = {
    "lmt_plane_mesh_select": [PTR] * 7 + [INT, INT, INT, PTR],
    "lmt_group_topk": [PTR] * 10 + [INT, INT, INT, PTR],
}


def pack_plane_mesh_buckets(m, pid, vcap):
    """Bucket the pairs by hull size and build each bucket's (Pb, 3+3D, V)
    table [vx, vy, vz, nbrx(D), nbry(D), nbrz(D)] (unused neighbour slots
    hold the owner vertex's coordinates, a sentinel the dedupe test always
    rejects) plus per-pair [margin, dedupe_r^2, extents lo(3), hi(3)].

    `m` has the model's numpy fields. Returns (subs, border) with subs
    entries (ids, tbl, marg, D) in bucket-major order, or None when a hull
    is graph-less (brute scan) or too large for the kernels."""
    pid = np.asarray(pid)
    pg2 = m.pair_geom2[pid]
    mesh_ids = np.maximum(np.asarray(m.geom_meshid)[pg2], 0)
    if np.asarray(m.mesh_brute)[mesh_ids].any():
        return None
    vmask = np.asarray(m.mesh_vertmask)[mesh_ids, :vcap]
    vraw = np.asarray(m.mesh_vert)[mesh_ids, :vcap]
    verts = np.where(vmask[:, :, None], vraw, vraw[:, 0:1, :]).astype(
        np.float32)
    counts = vmask.sum(axis=1)
    margin = np.asarray(m.pair_margin)[pid].astype(np.float32)
    dedupe = 0.3 * np.asarray(m.geom_rbound)[pg2].astype(np.float32)

    def bucket_size(c):
        c = max(int(c), 8)
        s = 32
        while s < c:
            s += 32
        return min(s, ((vcap + 7) // 8) * 8)

    buckets: dict = {}
    for p in range(len(pid)):
        buckets.setdefault(bucket_size(counts[p]), []).append(p)
    if max(buckets) > MESH_VCAP:
        return None

    subs, order = [], []
    for vb, ids in sorted(buckets.items()):
        ids = np.asarray(ids)
        tabs = [m.mesh_nbr[mesh_ids[p]] for p in ids]
        D = max(1, max(t.shape[1] for t in tabs))
        tbl = np.zeros((len(ids), 3 + 3 * D, vb), np.float32)
        for i, p in enumerate(ids):
            nv = int(counts[p])
            v = verts[p, : min(nv, vb)]
            tbl[i, 0:3, : v.shape[0]] = v.T
            if vb > nv:  # pad with vertex-0 duplicates (tie-safe)
                tbl[i, 0:3, nv:] = tbl[i, 0:3, 0:1]
            t = tabs[i][:vb]
            nbr = np.full((vb, D), -1, np.int32)
            nbr[: t.shape[0], : t.shape[1]] = t
            valid = nbr >= 0
            coords = verts[p][np.maximum(nbr, 0)]  # (vb, D, 3)
            # owner coordinates of every table row, vertex-0 padded to vb
            # (the reference indexes verts[p][:vb], short by vb - vcap rows
            # when the bucket size is rounded past vcap)
            vp = np.concatenate(
                [verts[p], np.repeat(verts[p][:1], max(0, vb - vcap), 0)])
            own = np.broadcast_to(vp[:vb, None, :], coords.shape)
            coords = np.where(valid[:, :, None], coords, own)
            tbl[i, 3: 3 + D] = coords[:, :, 0].T
            tbl[i, 3 + D: 3 + 2 * D] = coords[:, :, 1].T
            tbl[i, 3 + 2 * D: 3 + 3 * D] = coords[:, :, 2].T
        lo = np.array([verts[p][vmask[p]].min(axis=0) for p in ids], np.float32)
        hi = np.array([verts[p][vmask[p]].max(axis=0) for p in ids], np.float32)
        marg = np.concatenate(
            [margin[ids, None], (dedupe[ids] ** 2)[:, None], lo, hi], axis=1
        ).astype(np.float32)  # (Pb, 8)
        subs.append((ids, tbl, marg, int(D)))
        order.append(ids)
    return subs, np.concatenate(order)


@dataclasses.dataclass
class MeshPlan:
    """Static plan of one kernel-gated plane-mesh group (numpy; device
    copies are made on first use and kept per device and dtype)."""

    k: int
    pid: np.ndarray  # (P,) pair ids in bucket-major order
    pg1: np.ndarray  # (P,) plane geom ids
    pg2: np.ndarray  # (P,) mesh geom ids
    used: np.ndarray  # (G,) geom ids whose poses the top-K reads
    pg_local: np.ndarray  # (P, 2) int32: pg1, pg2 as indices into `used`
    tbl16: np.ndarray  # (P, 16) [key margin, meta(15)]
    buckets: list  # (start, count, D, table (Pb, 3+3D, V), marg (Pb, 8))
    flat: np.ndarray  # every pair's table, concatenated
    pair_i: np.ndarray  # (P, 3) int32: offset into flat, V, D
    pair_f: np.ndarray  # (P, 8) float32
    smem_bytes: int  # largest per-pair table, bytes
    verts: np.ndarray  # (P, V, 3) hull vertices, for the plain versions
    vmask: np.ndarray  # (P, V) bool
    nbr: np.ndarray  # (P, V, D) int64 hull-graph neighbours, -1 unused
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def P(self) -> int:
        return len(self.pid)

    def tensors(self, device, dtype=torch.float32) -> SimpleNamespace:
        key = (str(device), dtype)
        hit = self._dev.get(key)
        if hit is None:
            f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
            i = lambda x: torch.as_tensor(x, device=device)
            hit = self._dev[key] = SimpleNamespace(
                tbl16=f(self.tbl16), flat=f(self.flat),
                pair_i=i(self.pair_i), pair_f=f(self.pair_f),
                pg_local=i(self.pg_local.astype(np.int64)),
                pg_local32=i(self.pg_local),
                verts=f(self.verts), vmask=i(self.vmask), nbr=i(self.nbr),
            )
        return hit


def graph_table(mesh_nbr, mesh_ids, vcap: int):
    """(P, vcap, D) int64 hull-graph neighbour ids of the meshes `mesh_ids`
    (-1 unused), or None when every hull is graph-less."""
    tabs = [mesh_nbr[mi] for mi in mesh_ids]
    if all(t is None for t in tabs):
        return None
    D = max(t.shape[1] for t in tabs if t is not None)
    nbr = np.full((len(tabs), vcap, D), -1, np.int64)
    for p, t in enumerate(tabs):
        if t is not None:
            nvt = min(t.shape[0], vcap)
            nbr[p, :nvt, : t.shape[1]] = t[:nvt]
    return nbr


def mesh_tables(leaves: dict, aux: dict, g) -> MeshPlan | None:
    """The hull tables and bucket order of plane-mesh group `g` at any
    budget k, or None where the reference's `pack_plane_mesh_buckets`
    refuses it (a graph-less hull, a hull past the vertex cap)."""
    pid = np.asarray(g.pair_ids)
    m = SimpleNamespace(**{n: aux[n] for n in (
        "pair_geom1", "pair_geom2", "geom_meshid", "mesh_brute",
        "mesh_vertmask", "mesh_nbr")},
        **{n: np.asarray(leaves[n]) for n in (
            "mesh_vert", "pair_margin", "geom_rbound", "pair_friction",
            "pair_solref", "pair_solimp", "pair_gap")})
    vcap = int(np.asarray(m.mesh_vertmask).shape[1])
    packed = pack_plane_mesh_buckets(m, pid, vcap)
    if packed is None:
        return None
    subs, border = packed
    pid_b = pid[border]
    pg1 = np.asarray(m.pair_geom1)[pid_b]
    pg2 = np.asarray(m.pair_geom2)[pid_b]

    tbl = np.zeros((len(pid_b), 16), np.float32)
    tbl[:, 0] = m.pair_margin[pid_b]
    tbl[:, 1] = pg1
    tbl[:, 2] = pg2
    tbl[:, 3:8] = m.pair_friction[pid_b]
    tbl[:, 8:10] = m.pair_solref[pid_b]
    tbl[:, 10:15] = m.pair_solimp[pid_b]
    tbl[:, 15] = m.pair_margin[pid_b] - m.pair_gap[pid_b]

    used = np.asarray(sorted(set(pg1.tolist()) | set(pg2.tolist())))
    lid = {int(gid): i for i, gid in enumerate(used)}
    pg_local = np.asarray([[lid[int(a)], lid[int(b)]]
                           for a, b in zip(pg1, pg2)], np.int32)

    buckets, flats, pair_i, pair_f = [], [], [], []
    start, off, smem = 0, 0, 0
    for ids, t, marg, D in subs:
        buckets.append((start, len(ids), D, t, marg))
        for i in range(len(ids)):
            flats.append(t[i].reshape(-1))
            pair_i.append((off, t.shape[2], D))
            off += t[i].size
            smem = max(smem, t[i].size * 4)
        pair_f.append(marg)
        start += len(ids)
    mesh_ids = np.maximum(np.asarray(m.geom_meshid)[pg2], 0)
    return MeshPlan(
        k=int(g.k), pid=pid_b, pg1=pg1, pg2=pg2, used=used,
        pg_local=pg_local, tbl16=tbl, buckets=buckets,
        flat=np.concatenate(flats), pair_i=np.asarray(pair_i, np.int32),
        pair_f=np.concatenate(pair_f), smem_bytes=int(smem),
        verts=m.mesh_vert[mesh_ids, :vcap],
        vmask=np.asarray(m.mesh_vertmask)[mesh_ids, :vcap],
        nbr=graph_table(m.mesh_nbr, mesh_ids, vcap),
    )


def staged_plan(g, tables: MeshPlan | None) -> MeshPlan | None:
    """The staged path's plan of plane-mesh group `g` from its
    `mesh_tables`: the tables where the group ranks its pairs (k < P),
    else None (the staged XLA ordering, see the module note)."""
    if tables is None or g.k >= tables.P:
        return None
    return tables


# --------------------------------------------------------------------------
# manifold select
# --------------------------------------------------------------------------


def first_argmin(x: torch.Tensor, dim: int):
    """(min, index of the first minimum) along `dim`."""
    m = x.min(dim=dim, keepdim=True).values
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    iota = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    idx = torch.where(x == m, iota, x.shape[dim]).min(dim=dim).values
    return m.squeeze(dim), idx


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (E, P, ...) gathered along the pair axis by idx (E, k)."""
    shape = idx.shape + x.shape[2:]
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, view.expand(shape))


def manifold_plain(verts, vmask, nbr, brute, a, b, margin, dedupe2):
    """Plain version of the select: the reference's XLA narrowphase
    (`collision._plane_mesh_narrow`, mjc_PlaneConvex): per pair and env the
    support vertex, then the first two hull-graph neighbours of it, in
    stored edge order, below the margin and outside the dedupe radius (all
    vertices in storage order for a graph-less hull).

    verts (P, V, 3) mesh-local, vmask (P, V) bool, nbr (P, V, D) neighbour
    ids (-1 unused; None when every hull is graph-less), brute (P,) numpy
    bool (graph-less hulls), a (E, P, 3) and b (E, P) the plane in the mesh
    frame (height a.v + b), margin and dedupe2 (squared radius) (P,).
    Returns dist (E, P, 3) (1e10 where a point is missing) and vsel
    (E, P, 3, 3) mesh-local points. The height sums run in the kernel's
    order, so both pick the same support vertex."""
    dev = a.device
    verts = torch.where(vmask[:, :, None], verts, verts[:, 0:1])
    h = (verts[..., 0] * a[..., 0:1] + verts[..., 1] * a[..., 1:2]
         + verts[..., 2] * a[..., 2:3] + b[..., None])  # (E, P, V)
    h = torch.where(vmask, h, torch.full_like(h, BIG))
    d0, i0 = first_argmin(h, 2)  # (E, P)
    E, P, V = h.shape
    vex = verts.expand(E, -1, -1, -1)
    v0 = torch.gather(vex, 2, i0[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]

    iota_v = torch.arange(V, device=dev)
    if nbr is None:
        cand = iota_v.expand(E, P, V)
        cand_valid = vmask & (iota_v != i0[..., None])
    else:
        W = max(nbr.shape[2], V) if brute.any() else nbr.shape[2]
        nbr = torch.nn.functional.pad(nbr, (0, W - nbr.shape[2]), value=-1)
        g_ids = torch.gather(nbr.expand(E, -1, -1, -1), 2,
                             i0[..., None, None].expand(-1, -1, 1, W))[:, :, 0]
        if brute.any():
            pad = W - V
            b_ids = torch.nn.functional.pad(iota_v.expand(E, P, V), (0, pad),
                                            value=-1)
            b_valid = torch.nn.functional.pad(
                vmask & (iota_v != i0[..., None]), (0, pad), value=False)
            bsel = torch.as_tensor(brute, device=dev)[:, None]
            cand = torch.where(bsel, b_ids, g_ids)
            cand_valid = torch.where(bsel, b_valid, g_ids >= 0)
        else:
            cand, cand_valid = g_ids, g_ids >= 0

    j = torch.clamp(cand, min=0)
    h_c = torch.gather(h, 2, j)  # (E, P, C)
    v_c = torch.gather(vex, 2, j[..., None].expand(-1, -1, -1, 3))
    e = (v_c - v0[:, :, None]) + (0.5 * d0)[..., None, None] * a[:, :, None]
    e2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
    qual = cand_valid & (h_c < margin[:, None]) & (e2 >= dedupe2[:, None])
    rank = torch.cumsum(qual.to(torch.int32), dim=2) * qual

    def pick(r):
        oh = rank == r
        has = oh.any(2)
        d = torch.where(oh, h_c, torch.zeros_like(h_c)).sum(2)
        v = torch.where(oh[..., None], v_c, torch.zeros_like(v_c)).sum(2)
        return torch.where(has, d, torch.full_like(d, BIG)), v

    d1, v1 = pick(1)
    d2, v2 = pick(2)
    return torch.stack([d0, d1, d2], dim=2), torch.stack([v0, v1, v2], dim=2)


def select_plain(plan: MeshPlan, a: torch.Tensor, b: torch.Tensor):
    """Plain version of the select kernel: a (P, 3, E), b (P, E) ->
    dist (P, 3, E), vsel (P, 9, E)."""
    t = plan.tensors(a.device, a.dtype)
    P, E = plan.P, a.shape[-1]
    dist, vsel = manifold_plain(
        t.verts, t.vmask, t.nbr, np.zeros(P, bool), a.permute(2, 0, 1),
        b.t(), t.pair_f[:, 0], t.pair_f[:, 1])
    return (dist.permute(1, 2, 0).contiguous(),
            vsel.reshape(E, P, 9).permute(1, 2, 0).contiguous())


def plane_mesh_select(plan: MeshPlan, a: torch.Tensor, b: torch.Tensor):
    """Manifold select for every pair and env (see the module note)."""
    if not a.is_cuda:
        return select_plain(plan, a, b)
    P, E = plan.P, a.shape[-1]
    kernels.require(a, "a", (P, 3, E))
    kernels.require(b, "b", (P, E))
    t = plan.tensors(a.device)
    dist = torch.empty((P, 3, E), dtype=torch.float32, device=a.device)
    vsel = torch.empty((P, 9, E), dtype=torch.float32, device=a.device)
    lib = kernels.library("plane_mesh", _SIGNATURES)
    rc = lib.lmt_plane_mesh_select(
        kernels.ptr(t.flat), kernels.ptr(t.pair_i), kernels.ptr(t.pair_f),
        kernels.ptr(a), kernels.ptr(b), kernels.ptr(dist), kernels.ptr(vsel),
        P, E, plan.smem_bytes, kernels.stream())
    kernels.check(rc, "plane_mesh_select")
    kernels.LAUNCHES["plane_mesh_select"] += 1
    return dist, vsel


# --------------------------------------------------------------------------
# group top-K
# --------------------------------------------------------------------------


def pair_topk(key, k, dist, vsel, n, qp, qR, ranked=False):
    """The XLA branch of the reference's `_plane_mesh_group`: per env the
    k pairs of smallest key (first index on ties; every pair in order when
    k >= P) and their contacts. `ranked`: k rounds of the first-index
    argmin at any k, k = P too (the rank loop of the reference's mega
    kernels, `pallas_fk._mesh_group_slots` :825-850: deepest pair first).
    key (E, P), dist (E, P, 3), vsel (E, P, 3, 3) mesh-local points, n
    (E, P, 3) plane normals, qp (E, P, 3) and qR (E, P, 3, 3) mesh poses ->
    sel (E, k), dist (E, k, 3), world positions (E, k, 3, 3) and frames
    (E, k, 3, 3)."""
    E, P = key.shape
    if k < P or ranked:
        sel = []
        for _ in range(k):
            _, i = first_argmin(key, 1)
            sel.append(i)
            key = key.scatter(1, i[:, None], BIG)
        sel = torch.stack(sel, dim=1)
    else:
        sel = torch.arange(P, device=key.device).expand(E, -1)
    n_s, dist_s = take(n, sel), take(dist, sel)
    w = take(qp, sel)[:, :, None] + torch.einsum(
        "ekij,eksj->eksi", take(qR, sel), take(vsel, sel))
    pos = w - n_s[:, :, None] * (0.5 * dist_s)[..., None]
    return sel, dist_s, pos, m3.make_frame(n_s)


def group_topk_plain(plan: MeshPlan, dist, vsel, gxp, gxm):
    """Plain version of the top-K kernel: `pair_topk` on the env-last
    operands, ranked at any k (the mega kernels' order, which the staged
    kernel meets only at k < P), with the kernel's inactive slots (key >=
    0): depth 1e10, zero position, the canonical frame and pair 0's meta.
    The key of a pair that cannot reach the margin is its support depth
    here and the conservative extent bound in the kernels: both lie at or
    past the margin, so such a pair ranks after every active one either
    way and its rank's slots are inactive, whichever pair it holds."""
    t = plan.tensors(dist.device, dist.dtype)
    P, E = dist.shape[0], dist.shape[-1]
    gxp_e = gxp.permute(2, 0, 1)  # (E, G, 3)
    gxm_e = gxm.permute(2, 0, 1).reshape(E, -1, 3, 3)
    g1, g2 = t.pg_local[:, 0], t.pg_local[:, 1]
    dist_e = dist.permute(2, 0, 1)  # (E, P, 3)
    key = dist_e[..., 0] - t.tbl16[:, 0]
    sel, ds, pos, frame = pair_topk(
        key, plan.k, dist_e, vsel.permute(2, 0, 1).reshape(E, P, 3, 3),
        gxm_e[:, g1, :, 2], gxp_e[:, g2], gxm_e[:, g2], ranked=True)
    act = (take(key, sel) < 0)[..., None]  # (E, k, 1)
    canon = torch.tensor([0.0, 0, 1, 0, 1, 0, -1, 0, 0], dtype=dist.dtype,
                         device=dist.device)
    outs = (torch.where(act, ds, BIG),
            torch.where(act, pos.reshape(E, -1, 9), 0.0),
            torch.where(act, frame.reshape(E, -1, 9), canon),
            torch.where(act, t.tbl16[sel, 1:], t.tbl16[0, 1:]))
    return tuple(o.permute(1, 2, 0).contiguous() for o in outs)


def group_topk(plan: MeshPlan, dist, vsel, gxp, gxm):
    """k deepest pairs per env and their contact slot data."""
    if not dist.is_cuda:
        return group_topk_plain(plan, dist, vsel, gxp, gxm)
    P, k, G, E = plan.P, plan.k, len(plan.used), dist.shape[-1]
    kernels.require(dist, "dist", (P, 3, E))
    kernels.require(vsel, "vsel", (P, 9, E))
    kernels.require(gxp, "gxp", (G, 3, E))
    kernels.require(gxm, "gxm", (G, 9, E))
    t = plan.tensors(dist.device)
    dev = dist.device
    ds = torch.empty((k, 3, E), dtype=torch.float32, device=dev)
    pos = torch.empty((k, 9, E), dtype=torch.float32, device=dev)
    fr = torch.empty((k, 9, E), dtype=torch.float32, device=dev)
    meta = torch.empty((k, 15, E), dtype=torch.float32, device=dev)
    lib = kernels.library("plane_mesh", _SIGNATURES)
    rc = lib.lmt_group_topk(
        kernels.ptr(dist), kernels.ptr(vsel), kernels.ptr(gxp),
        kernels.ptr(gxm), kernels.ptr(t.tbl16), kernels.ptr(t.pg_local32),
        kernels.ptr(ds), kernels.ptr(pos), kernels.ptr(fr), kernels.ptr(meta),
        P, k, E, kernels.stream())
    kernels.check(rc, "group_topk")
    kernels.LAUNCHES["group_topk"] += 1
    return ds, pos, fr, meta
