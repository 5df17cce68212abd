"""Plane-mesh contact slots on the card: one kernel from a plane-mesh
group's geom poses to its k contact slots.

Counterpart of `loco_mujoco_tpu/ops/pallas_collision.py`'s
`make_group_topk`, which chains the per-pair manifold select (`_make_kernel`
/ `_select_batched_raw`) and the per-env top-K slot pick
(`_topk_kernel_builder`) behind one `topk(a, b, gxp, gxm)`; here one CUDA
kernel, `csrc/plane_mesh.cu`, behind one entry point, `mesh_slots`. The
static tables come from this module's own numpy copy of
`pack_plane_mesh_buckets`.

`mesh_tables` builds, once at model load, a plane-mesh group's hull tables
and bucket order at any budget k, or None where the reference's packing
refuses the group (a graph-less hull, a hull past the vertex cap); the
mega plans (`ops/plan.py`) take them at any k, k = P too, as the
reference's do (`pallas_fk.py:449-458`). `staged_plan` is the reference's
static gate of the kernel on the staged path: a group runs it only if it
has more pairs than slots (k < P). With k >= P the reference's staged XLA
path keeps its pairs in order (`collision.py:397-410`, its
`_pallas_group_topk_fn` stepping aside at `:438-442`), and so does the
port's (`collision._plane_mesh_xla`); its mega kernels rank them all
(`pallas_fk._mesh_group_slots`, `:825-850`), and so do the port's, their
plain version and this kernel (`pair_topk(ranked=True)`'s order at any
k <= P). The kernel takes float32 only: a CUDA tensor of another dtype
raises, and float64 on the CPU keeps the XLA port.

`mesh_slots(plan, geom_xpos, geom_xmat, key_out=None)` reads the poses
(E, ngeom, 3) and (E, ngeom, 3, 3) as Data holds them and returns the
group's slots env-major: dist (E, k, 3), pos (E, k, 3, 3), frame
(E, k, 3, 3) (one per pair), geom1 and geom2 (E, k) int64, friction
(E, k, 5), solref (E, k, 2), solimp (E, k, 5) and margin - gap (E, k),
each contiguous or a view of one output, as `collision.collision`
concatenates them; `key_out` (E, P), if given, receives every pair's
ranking key. A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version, `mesh_slots_plain`: `plane_in_mesh_frame`, then
`manifold_plain` and `pair_topk(ranked=True)`, the ports of the
reference's XLA narrowphase (`collision._plane_mesh_narrow`) and of the
XLA branch of its `_plane_mesh_group`, which `collision.py` runs as its
XLA path too. The two differ only where no contact is: the kernel takes
the conservative extent bound (`extent_bound`) as the depth, and the key,
of a pair that cannot reach the margin, and computes no manifold for it.

Stacked model variants whose hulls differ (the 4-ages scalings scale the
meshes; the hull graph is scale-invariant) give a plan K hull tables, one
per variant (`stack_plans`): the vertex tables, extents, dedupe radii and
statics one after another, the pairs, bucket order and neighbour tables
shared. `mesh_slots(..., env_id=)` and its plain version then read each
env's variant's table; K = 1 is one model's tables, as every other path
has them. The reference computes such slots in XLA (its Pallas kernels
step aside for traced hull vertices, `collision.py:436-452`); it is the
same function, held to the same plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from . import kernels
from . import math as m3
from .kernels import INT, PTR

BIG = 1e10
MESH_VCAP = 5632  # largest bucket the kernels take (pallas_collision.py:333)
MAX_PAIRS = 1024  # csrc/plane_mesh.cu kMaxPairs
ENVS_PER_BLOCK = 4  # csrc/plane_mesh.cu kEnvs: a warp per env
META = 13  # friction (5), solref (2), solimp (5), margin - gap
CANON = (0.0, 0.0, 1.0, 0.0, 1.0, 0.0, -1.0, 0.0, 0.0)  # an inactive frame

_SIGNATURES = {
    "lmt_mesh_slots": [PTR] * 13 + [INT] * 5 + [PTR],
    "lmt_mesh_slots_occupancy": [INT, INT, INT, PTR],
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
    copies are made on first use and kept per device and dtype). The
    per-variant tables (`tbl16`, `flat`, `pair_f`, `verts`) hold K
    variants' one after another (`stack_plans`): K = 1 is one model's."""

    k: int
    pid: np.ndarray  # (P,) pair ids in bucket-major order
    pg1: np.ndarray  # (P,) plane geom ids
    pg2: np.ndarray  # (P,) mesh geom ids
    tbl16: np.ndarray  # (K P, 16) [key margin, geom1, geom2, meta(13)]
    buckets: list  # (start, count, D, table (Pb, 3+3D, V), marg (Pb, 8))
    flat: np.ndarray  # every pair's table, concatenated, per variant
    pair_i: np.ndarray  # (P, 3) int32: offset into a variant's flat, V, D
    pair_f: np.ndarray  # (K P, 8) float32
    verts: np.ndarray  # (K P, V, 3) hull vertices, for the plain versions
    vmask: np.ndarray  # (P, V) bool
    nbr: np.ndarray  # (P, V, D) int64 hull-graph neighbours, -1 unused
    K: int = 1  # variants (hull tables)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def P(self) -> int:
        return len(self.pid)

    @property
    def table_floats(self) -> int:
        """Floats of one variant's hull table in `flat`."""
        return self.flat.size // self.K

    def tensors(self, device, dtype=torch.float32) -> SimpleNamespace:
        """The tables on `device`: `pair_k` (P, 5) int32 [offset, V, D,
        geom1, geom2] is the kernel's pair table; `pg1`, `pg2` int64."""
        key = (str(device), dtype)
        hit = self._dev.get(key)
        if hit is None:
            f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
            i = lambda x: torch.as_tensor(x, device=device)
            pair_k = np.concatenate([self.pair_i, self.pg1[:, None],
                                     self.pg2[:, None]], 1).astype(np.int32)
            hit = self._dev[key] = SimpleNamespace(
                tbl16=f(self.tbl16), flat=f(self.flat), pair_k=i(pair_k),
                pair_f=f(self.pair_f), pg1=i(self.pg1.astype(np.int64)),
                pg2=i(self.pg2.astype(np.int64)), verts=f(self.verts),
                vmask=i(self.vmask), nbr=i(self.nbr),
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

    buckets, flats, pair_i, pair_f = [], [], [], []
    start, off = 0, 0
    for ids, t, marg, D in subs:
        buckets.append((start, len(ids), D, t, marg))
        for i in range(len(ids)):
            flats.append(t[i].reshape(-1))
            pair_i.append((off, t.shape[2], D))
            off += t[i].size
        pair_f.append(marg)
        start += len(ids)
    mesh_ids = np.maximum(np.asarray(m.geom_meshid)[pg2], 0)
    return MeshPlan(
        k=int(g.k), pid=pid_b, pg1=pg1, pg2=pg2, tbl16=tbl, buckets=buckets,
        flat=np.concatenate(flats), pair_i=np.asarray(pair_i, np.int32),
        pair_f=np.concatenate(pair_f),
        verts=m.mesh_vert[mesh_ids, :vcap],
        vmask=np.asarray(m.mesh_vertmask)[mesh_ids, :vcap],
        nbr=graph_table(m.mesh_nbr, mesh_ids, vcap),
    )


def stack_plans(plans) -> MeshPlan:
    """One plan of K variants' plans of one group (`io.stack_variants`):
    the same pairs, bucket order, hull layout (vertex counts, neighbour
    tables) and budget, each variant's vertex table, extents, dedupe
    radii and statics one after another; raises where the layouts
    differ. A plan equal in every variant stays as it is (K = 1)."""
    base = plans[0]
    for i, p in enumerate(plans[1:], 1):
        same = (p.k == base.k and np.array_equal(p.pid, base.pid)
                and np.array_equal(p.pair_i, base.pair_i)
                and np.array_equal(p.vmask, base.vmask)
                and (p.nbr is None) == (base.nbr is None)
                and (p.nbr is None or np.array_equal(p.nbr, base.nbr)))
        if not same:
            raise ValueError(f"variant {i}'s plane-mesh hull layout differs "
                             f"from variant 0's")
    if all(np.array_equal(p.flat, base.flat)
           and np.array_equal(p.pair_f, base.pair_f)
           and np.array_equal(p.tbl16, base.tbl16) for p in plans[1:]):
        return base
    return dataclasses.replace(
        base, K=len(plans), _dev={},
        tbl16=np.concatenate([p.tbl16 for p in plans]),
        flat=np.concatenate([p.flat for p in plans]),
        pair_f=np.concatenate([p.pair_f for p in plans]),
        verts=np.concatenate([p.verts for p in plans]))


def staged_plan(g, tables: MeshPlan | None) -> MeshPlan | None:
    """The staged path's plan of plane-mesh group `g` from its
    `mesh_tables`: the tables where the group ranks its pairs (k < P),
    else None (the staged XLA ordering, see the module note)."""
    if tables is None or g.k >= tables.P:
        return None
    return tables


# --------------------------------------------------------------------------
# plain versions: the plane in the mesh frame, the manifold, the top-K
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


def plane_in_mesh_frame(gxp, gxm, pg1, pg2):
    """The plane of each pair in its mesh's frame: normal a (E, P, 3) and
    offset b (E, P), so that a mesh-local vertex v lies a.v + b above it,
    from the geom poses gxp (E, ngeom, 3) and gxm (E, ngeom, 3, 3) and the
    pairs' plane and mesh geom ids. Written as the kernels' separate
    products and sums, in their order (csrc/plane_mesh.cu, csrc/mega.cu
    `mesh_group`: a_j = (R_0j n_0 + R_1j n_1) + R_2j n_2), so that a
    support-vertex tie within an ulp resolves the same way on every
    device."""
    n = gxm[:, pg1, :, 2]  # (E, P, 3)
    R = gxm[:, pg2]  # (E, P, 3, 3)
    a = ((R[..., 0, :] * n[..., 0:1] + R[..., 1, :] * n[..., 1:2])
         + R[..., 2, :] * n[..., 2:3])
    d = gxp[:, pg2] - gxp[:, pg1]
    b = (n[..., 0] * d[..., 0] + n[..., 1] * d[..., 1]) + n[..., 2] * d[..., 2]
    return a, b


def extent_bound(pair_f, a, b):
    """The kernel's conservative bound lb <= min_v (a.v + b) (E, P) from
    each hull's extents (`pair_f` (P, 8) [margin, dedupe^2, lo (3), hi
    (3)], or each env's (E, P, 8)), in the kernel's order: a pair whose
    bound does not reach its margin cannot touch, and the kernel walks no
    vertex of it."""
    lb = b - 1e-6
    for i in range(3):
        lb = lb + torch.minimum(a[..., i] * pair_f[..., 2 + i],
                                a[..., i] * pair_f[..., 5 + i])
    return lb


def manifold_plain(verts, vmask, nbr, brute, a, b, margin, dedupe2):
    """Plain version of the select: the reference's XLA narrowphase
    (`collision._plane_mesh_narrow`, mjc_PlaneConvex): per pair and env the
    support vertex, then the first two hull-graph neighbours of it, in
    stored edge order, below the margin and outside the dedupe radius (all
    vertices in storage order for a graph-less hull).

    verts (P, V, 3) mesh-local, or (E, P, V, 3) each env's, vmask (P, V)
    bool, nbr (P, V, D) neighbour ids (-1 unused; None when every hull is
    graph-less), brute (P,) numpy bool (graph-less hulls), a (E, P, 3) and
    b (E, P) the plane in the mesh frame (height a.v + b), margin and
    dedupe2 (squared radius) (P,), or (E, P) each env's.
    Returns dist (E, P, 3) (1e10 where a point is missing) and vsel
    (E, P, 3, 3) mesh-local points. The height sums run in the kernel's
    order, so both pick the same support vertex."""
    dev = a.device
    verts = torch.where(vmask[:, :, None], verts, verts[..., 0:1, :])
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
    qual = cand_valid & (h_c < margin[..., None]) & (e2 >= dedupe2[..., None])
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


# --------------------------------------------------------------------------
# the kernel: a group's geom poses -> its k contact slots
# --------------------------------------------------------------------------


def variant_tables(plan: MeshPlan, t, env_id):
    """(verts, pair_f, tbl16) of each env: the plan's tables ((P, V, 3),
    (P, 8), (P, 16)) where it holds one variant, else each env's
    variant's, (E, ...) by `env_id` (E,)."""
    if plan.K == 1:
        return t.verts, t.pair_f, t.tbl16
    if env_id is None:
        raise ValueError(f"mesh_slots: a plan of {plan.K} variants' hull "
                         f"tables needs each env's variant (env_id)")
    P = plan.P
    return (t.verts.reshape(plan.K, P, *t.verts.shape[1:])[env_id],
            t.pair_f.reshape(plan.K, P, -1)[env_id],
            t.tbl16.reshape(plan.K, P, -1)[env_id])


def mesh_slots_plain(plan: MeshPlan, gxp, gxm, key_out=None, env_id=None):
    """Plain version of `mesh_slots`: every pair's manifold
    (`manifold_plain`) on each env's hull table, the k smallest keys,
    ranked at any k (`pair_topk(ranked=True)`: the mega kernels' order,
    which the staged path meets only at k < P), and the kernel's inactive
    ranks (key >= 0): depth 1e10, zero position, the canonical frame and
    pair 0's statics. The key of a pair that cannot reach the margin is
    its support depth here and the conservative extent bound in the
    kernel: both lie at or past the margin, so such a pair ranks after
    every active one either way and its rank's slots are inactive,
    whichever pair it holds."""
    t = plan.tensors(gxp.device, gxp.dtype)
    verts, pf, st = variant_tables(plan, t, env_id)
    a, b = plane_in_mesh_frame(gxp, gxm, t.pg1, t.pg2)
    dist, vsel = manifold_plain(
        verts, t.vmask, t.nbr, np.zeros(plan.P, bool), a, b,
        pf[..., 0], pf[..., 1])
    key = dist[..., 0] - st[..., 0]
    if key_out is not None:
        key_out.copy_(key)
    sel, ds, pos, frame = pair_topk(
        key, plan.k, dist, vsel, gxm[:, t.pg1, :, 2], gxp[:, t.pg2],
        gxm[:, t.pg2], ranked=True)
    act = take(key, sel) < 0  # (E, k)
    canon = torch.tensor(CANON, dtype=gxp.dtype, device=gxp.device)
    on = act[..., None, None]
    if plan.K == 1:
        meta = torch.where(act[..., None], st[sel, 3:], st[0, 3:])
    else:
        meta = torch.where(act[..., None], take(st, sel)[..., 3:],
                           st[:, None, 0, 3:])
    return (torch.where(act[..., None], ds, BIG), torch.where(on, pos, 0.0),
            torch.where(on, frame, canon.reshape(3, 3)),
            torch.where(act, t.pg1[sel], t.pg1[0]),
            torch.where(act, t.pg2[sel], t.pg2[0]), meta[..., 0:5],
            meta[..., 5:7], meta[..., 7:12], meta[..., 12])


def check(plan: MeshPlan, gxp, gxm, key_out=None, env_id=None) -> None:
    """The kernel's operands: CUDA float32 contiguous poses (E, ngeom, 3)
    and (E, ngeom, 3, 3), key_out (E, P) if given, each env's variant
    env_id (E,) int32 in [0, K) where the plan holds K > 1 hull tables,
    and a plan within the kernel's limits (k <= P <= MAX_PAIRS); else it
    raises."""
    E, G = gxp.shape[0], gxp.shape[1]
    if plan.K > 1 and env_id is None:
        raise ValueError(f"mesh_slots: a plan of {plan.K} variants' hull "
                         f"tables needs each env's variant")
    kernels.require(gxp, "geom_xpos", (E, G, 3))
    kernels.require(gxm, "geom_xmat", (E, G, 3, 3))
    if key_out is not None:
        kernels.require(key_out, "key_out", (E, plan.P))
    if plan.K > 1:
        kernels.require(env_id, "env_id", (E,), torch.int32)
    if not 0 < plan.k <= plan.P <= MAX_PAIRS:
        raise ValueError(f"mesh_slots: k {plan.k} and {plan.P} pairs, the "
                         f"kernel takes 0 < k <= P <= {MAX_PAIRS}")


def _views(flat, shapes):
    """Contiguous views of `flat`, one after another, of `shapes`."""
    out, offset = [], 0
    for shape in shapes:
        strides, n = [], 1
        for d in reversed(shape):
            strides.insert(0, n)
            n *= d
        out.append(flat.as_strided(shape, strides, offset))
        offset += n
    return out


def mesh_slots(plan: MeshPlan, geom_xpos, geom_xmat, key_out=None,
               env_id=None):
    """The group's k contact slots per env from its geom poses, in one
    launch (see the module note); `env_id` (E,) picks each env's hull
    table where the plan holds K > 1 (int32 on the card; an int64 tensor
    is cast)."""
    if not geom_xpos.is_cuda:
        return mesh_slots_plain(plan, geom_xpos, geom_xmat, key_out, env_id)
    if plan.K == 1:
        env_id = None
    elif env_id is not None and env_id.dtype != torch.int32:
        env_id = env_id.to(torch.int32)
    check(plan, geom_xpos, geom_xmat, key_out, env_id)
    P, k = plan.P, plan.k
    E, G = geom_xpos.shape[0], geom_xpos.shape[1]
    t = plan.tensors(geom_xpos.device)
    ds, pos, frame, meta = _views(
        geom_xpos.new_empty(E * k * (21 + META)),
        ((E, k, 3), (E, k, 3, 3), (E, k, 3, 3), (E, k, META)))
    ids = torch.empty((E, k, 2), dtype=torch.int64, device=geom_xpos.device)
    lib = kernels.library("plane_mesh", _SIGNATURES)
    rc = lib.lmt_mesh_slots(
        geom_xpos.data_ptr(), geom_xmat.data_ptr(), t.flat.data_ptr(),
        t.pair_k.data_ptr(), t.pair_f.data_ptr(), t.tbl16.data_ptr(),
        None if env_id is None else env_id.data_ptr(),
        ds.data_ptr(), pos.data_ptr(), frame.data_ptr(), ids.data_ptr(),
        meta.data_ptr(), None if key_out is None else key_out.data_ptr(),
        P, k, E, G, plan.table_floats, kernels.stream())
    kernels.check(rc, "mesh_slots")
    kernels.LAUNCHES["mesh_slots"] += 1
    return (ds, pos, frame, ids[..., 0], ids[..., 1], meta[..., 0:5],
            meta[..., 5:7], meta[..., 7:12], meta[..., 12])


def shared_bytes(plan: MeshPlan) -> int:
    """The kernel's shared memory per env: each pair's key, support depth
    and vertex, each rank's pair and key."""
    return 4 * (3 * plan.P + 2 * plan.k)


def occupancy(plan: MeshPlan) -> int:
    """Resident warps (envs) per SM of the kernel's launch for the plan
    (its K-table instance where it holds K > 1), from the CUDA runtime
    (needs the card)."""
    out = (ctypes.c_int * 1)()
    kernels.check(kernels.library("plane_mesh", _SIGNATURES)
                  .lmt_mesh_slots_occupancy(plan.P, plan.k, int(plan.K > 1),
                                            ctypes.addressof(out)),
                  "mesh_slots occupancy")
    return out[0]
