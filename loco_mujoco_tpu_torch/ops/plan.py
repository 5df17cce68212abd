"""The static plan of the fused constraint kernel and of the mega path.

Counterpart of `loco_mujoco_tpu/ops/pallas_constraint.py`'s `RowPlan`
(`:59-461`, `:632-758`), with the FK plan (`pallas_fk.FkPlan`) and the
collision plans (`pallas_fk.ColPlan`, `ColPlanExt`) of its mega branches
folded in. It is built once, at load (`core/io.model_from_numpy`), from the
model arrays and the static contact layout; a model outside the row
envelope gets no plan (`build_plan` returns None) and keeps the staged path
with the standalone Newton kernel, as the reference does.

The row envelope (a plan, and the fused kernel of `csrc/fused.cu`):

- pyramidal cones with every contact slot condim 3, or elliptic cones
  (`elliptic`) with condim 1, 3, 4 or 6 (dim rows per slot, `rows_per`,
  `:76-82`, `:178-182`); one kinematic tree, the constraint stage on, the
  batched Newton budget (iterations <= 16, ls_iterations <= 8);
- JOINT equalities, dof friction loss and joint limits; at most
  `ROWS_MAX` rows (the reference's `LMT_MAX_PYR_ROWS`, `:202-210`), or,
  elliptic, `ELL_ROWS_MAX` rows and nv <= 24 (`:211-214`);
- hinge and slide joints and the kernels' compiled widths: nv up to
  `NV_MAX`, the wider of the two nv widths the kernels are compiled at
  (`NV_WIDTHS`; the plan's `nvm` is the narrower one that holds the
  model), and `BODY_MAX` bodies.

The convex (GJK) groups at the tail of the slot layout are left out of the
rows (`collision.classic_ncon`): their slots stay inactive in float32, as
in the reference.

`smooth` (`_build_smooth`, `:495-627`) is set for models without tendons or
activations: the fused kernel then rebuilds the smooth stage from the FK
outputs (the smooth vec layout). Its actuator table (F_ACT / I_ACT) holds
per joint actuator the reference's `sm_acts` (`:565-584`): the qpos and dof
addresses, gear, gainprm[0:3] and biasprm[0:3] with the affine flags (a
position servo: fixed gain, affine bias), the ctrl and force limits.
Other models (the muscle humanoid, or joint actuators with integrator or
filter activations) get a non-smooth plan: the staged path computes com,
cinert, cdof and qfrc_smooth and hands them to the fused kernel (the
non-smooth vec layout, `_forward_env_block` `:1282-1299`). A joint actuator
with an activation also keeps the mega path off (`:561-577`), in a muscle
model too.

Within it, the contact pack the fused kernel reads per slot (`pack_w`,
`:750-757`) is 5 floats when every candidate pair shares one static plane,
solref, solimp, margin, gap (`uniform`, `_check_uniform`, pyramidal only)
and sliding friction (`fric_uniform`), 7 with per-pair friction, and the
generic 24 + `nfric` otherwise: 26 pyramidal, 29 elliptic (5 frictions,
torsion and rolling). Elliptic plans also carry `ell_runs` (`:286-299`:
first row, contacts and dim of each run of equal-dim slots of dim >= 3),
which the solve's cone zones walk, and `impratio`. Euler models get the
in-kernel implicit damping `euler_dv` (`:314-329`) unless EULERDAMP is
disabled.

`mega` (one kernel per forward, `csrc/mega.cu`, a warp per env with its
state in shared memory sized by `mega_launch`) is a flag on the plan: set
for uniform statics with uniform friction, contacts against that one plane
in at most one plane-box group, one plane-cylinder group and one
plane-mesh group with graph hulls within the vertex cap (its
`hopper_collision.mesh_tables`, at any budget k: the mega kernels rank
its pairs, k = P too, as the reference's mega kernels do,
`pallas_fk._mesh_group_slots`; `mesh`), and the compiled widths
`CON_MAX`, `PAIR_MAX`. A non-smooth model takes the mega path through the in-kernel
tendon and muscle stage (`smooth_mu`, the reference's
`_build_smooth(allow_muscle=True)` `:366-378`, with the tables of
`MusclePlan`, `pallas_fk.py:1001-1128`, within `MUS_MAX` muscles); the
joint motors beside the muscles keep the smooth stage's actuator table.
A smooth model of either cone that the plane-only plan refuses takes it
with the extended collision (`mega_ell`, the reference's gate `:428-461`;
its tables `ext`, the port's `ColPlanExt`, `pallas_fk.py:1507-1697`):
every classic analytic group kind and one plane-mesh group at any k (its
`MeshPlan`'s pairs and hull tables, `ext_mesh`),
per-group uniform statics, one static plane on the world body, both geoms
of self pairs. Elliptic cones keep their dim rows per slot (A1), pyramidal
ones the four blocked facets per slot and `euler_dv` (G1); the kernels
have an instance each (`hopper_mega.ext_mode`), and the per-env shared
state of a pyramidal extended plan is the plane-only one's with the
generic slots (`mega_census`: `ext` without `ell`). The reference's
`ell_fast` branch specialization (`:301-312`, `:463-493`: a reduced slot
subset when no env of a TPU block has an outside slot active) is not
ported: the port's threads skip their own inactive rows in every solve
pass, which makes the reduced branch's saving without a branch (as for
the pyramidal fast and full branches).

Leaves that differ from env to env (stacked variants, domain
randomization) turn parts of the plan off as the reference's traced
leaves do (`per_env`, chosen once where the env is built): the row plan
(none: the staged path and the Newton kernel), the smooth stage (the
fused kernel's non-smooth layout, whose vector carries each env's
cinert and armature), the plane plan's uniform pack (the generic one) and
the mega path. Per-env joint damping (domain randomization) keeps the
fused and mega paths: `dyn_damping()` is the plan's variant with the reference's
`sm_dyn_damping` (`:529-537`), flag `DAMP_ROWS`, whose kernels read each
env's damping from an (E, nv) operand (`Data.dof_damping`) instead of
F_DOF's column, and which has no `euler_dv` (`:314-329`: Euler's implicit
damping is then solved outside the kernels). The plan without it, its
tables and its kernels stay as they are.

Float64 data gets no plan (`maybe_plan`), as in the reference. A
plane-mesh group at k = P is ranked by the mega kernels (deepest pair
first, first index on ties), as the reference's mega kernels rank it
(`pallas_fk.py:825-850`); only the reference's staged XLA path keeps such
a group's pairs in order (`collision.py:397-410`), and so does the port's
staged path (`collision._plane_mesh_xla`; `Model.mesh_kernel` is None
there). The mega kernels' plain version ranks it too
(`collision.collision(ranked=True)`).

`tables(device)` packs the plan into the two read-only buffers the kernels
of `csrc/mega.cu` and `csrc/fused.cu` take: an int32 buffer that starts with
the header `HEADER` (counts and the offsets of every table) and a float32
buffer.

The warp-per-env kernels (`csrc/warp_core.cuh`) hold each env's state in
shared memory laid out by a launch census (`WarpLaunch`: offsets per
region in `SHM` order, envs per block, the resident warps per SM that
shared memory allows, the rows' J in shared memory or in a per-env global
scratch): the mega kernels' `mega_launch(plan)` (its table is the plan's
I_SHM), the fused kernel's `fused_launch(plan)` and the standalone Newton
kernel's `solve_launch(nv, nrows, ne, nfl)` (their tables go to the
launchers as an int32 operand). A census that leaves fewer than
`RESIDENT_FLOOR` warps per SM, J moved out where allowed, raises.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.types import (BiasType, ConeType, DisableBit, DynType, EqType,
                          GainType, GeomType, IntegratorType, JointType,
                          TrnType)
from .kernels import NV_WIDTHS, nv_width

MINVAL = 1e-15
# the per-lane array widths compiled in csrc/forward_core.cuh (NVM, the
# macro LMT_NVM): each kernel library is built at 24 and, for nv 25-32, at
# 32
NV_MAX = NV_WIDTHS[-1]
BODY_MAX = 32
CON_MAX = 80  # csrc/mega.cu
PAIR_MAX = 128
ROWS_MAX = 400  # the reference's LMT_MAX_PYR_ROWS default
ELL_ROWS_MAX = 320  # the reference's elliptic envelope (:211-214)
MUS_MAX = 128  # muscles and activations (csrc/forward_core.cuh)

# int header of the packed tables; csrc/forward_core.cuh's `enum Header`
# lists the same names in the same order (tests/test_torch_mega_plan.py
# checks it)
HEADER = (
    "NQ", "NV", "NBODY", "NJNT", "NU", "NE", "NFL", "NL", "NPAD", "NROWS",
    "NCON", "FLAGS", "NBOX", "KBOX", "OFFBOX", "NCYL", "KCYL", "OFFCYL",
    "NMESH", "KMESH", "OFFMESH", "F_BODY", "I_BODY", "I_TOPO", "F_JNT",
    "I_JNT", "F_DOF", "I_DOF", "I_ANC", "I_DMASK", "F_ACT", "I_ACT", "F_EQ",
    "I_EQ", "F_FL", "I_FL", "F_LIM", "I_LIM", "F_CON", "F_BOX", "I_BOX",
    "F_CYL", "I_CYL", "F_MESH", "I_MESH",
    "F_VERT", "PACKW", "I_GBODY", "NMOT", "NA", "NMUS", "F_MUS", "I_MUS",
    "I_SEG", "F_SITE", "I_SITE", "F_ACTB", "NELL", "I_ELL", "NXGRP",
    "I_XGRP", "F_XGRP", "I_XPAIR", "F_XPAIR", "I_CON", "I_SHM",
)
H = {name: i for i, name in enumerate(HEADER)}
# FLAGS bits
PASSIVE, ACTUATION, CLAMPCTRL, REFSAFE = 1, 2, 4, 8
UNIFORM, FRIC_UNIFORM, SMOOTH, MUSCLE = 16, 32, 64, 128
ELLIPTIC = 256
DAMP_ROWS = 512  # per-env joint damping (RowPlan.dyn_damping)
# per-entry widths of the tables (floats / ints), as the kernels read them
WIDTH = {"F_BODY": 20, "I_BODY": 4, "F_JNT": 10, "I_JNT": 4, "F_DOF": 2,
         "I_DOF": 1, "F_ACT": 12, "I_ACT": 8, "F_EQ": 16, "I_EQ": 4,
         "F_FL": 10, "I_FL": 1, "F_LIM": 12, "I_LIM": 2, "F_CON": 32,
         "F_BOX": 12, "I_BOX": 2, "F_CYL": 12, "I_CYL": 2, "F_MESH": 16,
         "I_MESH": 5, "F_MUS": 28, "I_MUS": 6, "I_SEG": 2, "F_SITE": 4,
         "I_SITE": 1, "F_ACTB": 2, "I_ELL": 3, "I_CON": 2, "I_XGRP": 8,
         "F_XGRP": 16, "I_XPAIR": 4, "F_XPAIR": 24}
# pair kinds of the extended in-kernel collision (ColPlanExt._SUP), as the
# kernels number them (csrc/mega.cu `collide_ext`)
EXT_KINDS = {(int(GeomType.PLANE), int(GeomType.SPHERE)): 0,
             (int(GeomType.PLANE), int(GeomType.CAPSULE)): 1,
             (int(GeomType.PLANE), int(GeomType.CYLINDER)): 2,
             (int(GeomType.PLANE), int(GeomType.BOX)): 3,
             (int(GeomType.SPHERE), int(GeomType.SPHERE)): 4,
             (int(GeomType.SPHERE), int(GeomType.CAPSULE)): 5,
             (int(GeomType.SPHERE), int(GeomType.BOX)): 6,
             (int(GeomType.CAPSULE), int(GeomType.CAPSULE)): 7,
             (int(GeomType.PLANE), int(GeomType.MESH)): 8}


def _floats(x):
    return [float(v) for v in np.asarray(x).ravel()]


def _quat_normal(q):
    """Third column of the rotation of the (normalised) quaternion q."""
    w, x, y, z = (float(v) for v in q)
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([2 * (x * z + w * y), 2 * (y * z - w * x),
                     1 - 2 * (x * x + y * y)])


def _make_frame(n):
    """mju_makeFrame rows (n, t1, t2), in numpy (collision.make_frame)."""
    ref = (np.array([0.0, 1.0, 0.0]) if abs(n[1]) < 0.5
           else np.array([0.0, 0.0, 1.0]))
    t1 = ref - n * float(np.dot(n, ref))
    t1 = t1 / np.linalg.norm(t1)
    return np.stack([n, t1, np.cross(n, t1)])


# Leaves the reference's plans read as constants (`_conc`), by plan: where
# one varies per env (a traced leaf there), that plan is off (`per_env`).
# The row plan's (`:92-101`, the friction loss's `:142`):
ROW_LEAVES = frozenset({
    "qpos0", "jnt_range", "jnt_margin", "jnt_solref", "jnt_solimp",
    "dof_solref", "dof_solimp", "dof_frictionloss", "dof_invweight0",
    "body_invweight0", "eq_data", "eq_solref", "eq_solimp", "opt.timestep",
    "opt.impratio"})
# the smooth stage's (`:519-530`, its actuator table `:545-549`):
SMOOTH_LEAVES = frozenset({
    "body_mass", "body_inertia", "jnt_stiffness", "qpos_spring",
    "dof_armature", "opt.gravity", "actuator_gear", "actuator_gainprm",
    "actuator_biasprm", "actuator_ctrlrange", "actuator_forcerange"})
# the plane plan's pair parameters and plane pose (`:651-656`):
PAIR_LEAVES = frozenset({
    "pair_solref", "pair_solimp", "pair_margin", "pair_gap",
    "pair_friction", "geom_quat"})


class RowPlan:
    """Static tables of the fused kernel and the mega path (see the module
    note). Field names follow the reference's RowPlan / FkPlan / ColPlan."""

    def __init__(self, L: dict, A: dict, groups, mesh_tables):
        self.ok = False
        self.mega = False
        self.sm_dyn_damping = False
        self._dyn = None  # dyn_damping's
        self._launch = None  # mega_launch's
        self._fused_launch = None  # fused_launch's
        self.uniform = self.fric_uniform = False
        self.groups = []
        self.ext_mesh = None  # _ext_plan's plane-mesh group
        nv, nb, njnt = int(A["nv"]), int(A["nbody"]), int(A["njnt"])
        flags = int(A["opt.disableflags"])
        # the convex tail's slots stay inactive in float32 and are left out
        # of the rows (the reference's classic_ncon truncation, :64-73)
        groups = [g for g in groups if not g.convex]
        self.elliptic = (bool(groups)
                         and int(A["opt.cone"]) == int(ConeType.ELLIPTIC))
        dims = [int(g.condim) for g in groups for _ in range(g.k * g.slots)]
        if any(d not in ((1, 3, 4, 6) if self.elliptic else (3,))
               for d in dims):
            return
        self.impratio = float(np.asarray(L["opt.impratio"]))
        self.ell_runs = ()
        self.mega_ell = False
        roots = np.asarray(A["body_rootid"])
        if roots[1:].size and not np.all(roots[1:] == roots[1]):
            return
        if flags & DisableBit.CONSTRAINT:
            return
        if not (int(A["opt.iterations"]) <= 16
                and int(A["opt.ls_iterations"]) <= 8):
            return
        # the smooth stage (_build_smooth): no tendons, no activations; a
        # joint actuator with an activation (integrator, filter) keeps the
        # muscle variant off too (`:561-577`)
        self.smooth = not (int(A["ntendon"]) or int(A["na"]))
        trn = np.asarray(A["actuator_trntype"])
        joint_dyn = bool(np.any(
            (trn != int(TrnType.TENDON))
            & (np.asarray(A["actuator_dyntype"]) != int(DynType.NONE))))
        self.smooth_mu = False
        self.mp = None
        self.na = int(A["na"])
        jt = np.asarray(A["jnt_type"])
        if not np.all((jt == int(JointType.HINGE))
                      | (jt == int(JointType.SLIDE))):
            return
        parent = [int(b) for b in np.asarray(A["body_parentid"])]
        if (nv > NV_MAX or nb > BODY_MAX or int(A["nq"]) != nv
                or njnt != nv):
            return
        f64 = {k: np.asarray(v, np.float64) for k, v in L.items()}
        self.nq, self.nv, self.nbody, self.njnt = nv, nv, nb, njnt
        self.nvm = nv_width(nv)  # the kernels' compiled width
        self.nu = int(A["nu"])
        self.timestep = float(f64["opt.timestep"])
        self.refsafe = not (flags & DisableBit.REFSAFE)
        self.iterations = int(A["opt.iterations"])
        self.ls_iterations = int(A["opt.ls_iterations"])
        self.scale = float(A["stat_meaninertia"]) * max(1, nv)
        # MuJoCo's default tolerance is out of reach in float32
        self.tolerance = max(float(A["opt.tolerance"]), 1e-6)
        qpos0 = f64["qpos0"]
        self.qpos0 = _floats(qpos0)
        qadr = np.asarray(A["jnt_qposadr"])
        dadr = np.asarray(A["jnt_dofadr"])
        dof_iw = f64["dof_invweight0"]

        # --- JOINT equalities ------------------------------------------
        eq_ids = ([] if flags & DisableBit.EQUALITY else
                  [e for e in range(int(A["neq"])) if A["eq_active0"][e]])
        if any(int(A["eq_type"][e]) != int(EqType.JOINT) for e in eq_ids):
            return
        self.eq = []
        for e in eq_ids:
            j1, j2r = int(A["eq_obj1id"][e]), int(A["eq_obj2id"][e])
            valid2 = 0 <= j2r < njnt and j2r != j1
            j2 = j2r if valid2 else j1
            self.eq.append(dict(
                q1=int(qadr[j1]), v1=int(dadr[j1]), q2=int(qadr[j2]),
                v2=int(dadr[j2]), m2=1.0 if valid2 else 0.0,
                data=_floats(f64["eq_data"][e, :5]),
                solref=_floats(f64["eq_solref"][e]),
                solimp=_floats(f64["eq_solimp"][e]),
                iw=float(dof_iw[int(dadr[j1])])
                + (float(dof_iw[int(dadr[j2])]) if valid2 else 0.0)))

        # --- dof friction loss -----------------------------------------
        self.fl = []
        if not flags & DisableBit.FRICTIONLOSS:
            for v in np.nonzero(np.asarray(A["dof_frictionloss0"]) > 0)[0]:
                self.fl.append(dict(
                    v=int(v), solref=_floats(f64["dof_solref"][v]),
                    solimp=_floats(f64["dof_solimp"][v]),
                    floss=float(f64["dof_frictionloss"][v]),
                    iw=float(dof_iw[v])))

        # --- joint limits ----------------------------------------------
        self.lim = []
        if not flags & DisableBit.LIMIT:
            for j in np.nonzero(np.asarray(A["jnt_limited"]))[0]:
                v = int(dadr[j])
                self.lim.append(dict(
                    q=int(qadr[j]), v=v, lo=float(f64["jnt_range"][j, 0]),
                    hi=float(f64["jnt_range"][j, 1]),
                    margin=float(f64["jnt_margin"][j]),
                    solref=_floats(f64["jnt_solref"][j]),
                    solimp=_floats(f64["jnt_solimp"][j]),
                    iw=float(dof_iw[v])))

        self.ncon = 0 if flags & DisableBit.CONTACT else len(dims)
        self.ne, self.nfl, self.nl = len(self.eq), len(self.fl), len(self.lim)
        # the reference pads the non-contact block to a multiple of 8 with
        # inert rows; the kernels keep that row layout (the pad rows are
        # inactive and cost nothing)
        self.npad = (8 - (self.ne + self.nfl + self.nl) % 8) % 8
        # rows per slot: 4 pyramidal facets, or dim elliptic rows (:178-182)
        self.con_dim = np.asarray(dims[:self.ncon], np.int32)
        self.rows_per = [1 if d == 1 else (d if self.elliptic else 4)
                         for d in self.con_dim]
        base = self.ne + self.nfl + self.nl + self.npad
        self.nrows = base + sum(self.rows_per)
        if self.nrows == 0:
            return
        if self.elliptic and (self.nrows > ELL_ROWS_MAX
                              or nv > NV_WIDTHS[0]):
            return  # the validated elliptic envelope (:211-214)
        if not self.elliptic and self.nrows > ROWS_MAX:
            return  # the standalone Newton kernel's staged path
        self.con_efcadr = (base + np.concatenate(
            [[0], np.cumsum(self.rows_per)[:-1]])).astype(np.int32) \
            if self.ncon else np.zeros(0, np.int32)
        # elliptic runs: contiguous equal-dim slots of dim >= 3, as
        # (first row, contacts, dim), for the solve's cone zones (:286-299)
        runs, i = [], 0
        while self.elliptic and i < self.ncon:
            j = i
            while j < self.ncon and self.con_dim[j] == self.con_dim[i]:
                j += 1
            if self.con_dim[i] >= 3:
                runs.append((int(self.con_efcadr[i]), j - i,
                             int(self.con_dim[i])))
            i = j
        self.ell_runs = tuple(runs)

        # --- tree tables ------------------------------------------------
        self.body_parent = parent
        if not all(parent[b] < b for b in range(1, nb)):
            return  # put_model orders parents first
        self.topo = list(range(1, nb))
        self.topo_rev = sorted(range(1, nb), reverse=True)
        self.dof_bodyid = [int(b) for b in np.asarray(A["dof_bodyid"])]
        self.anc = np.asarray(A["dof_ancestor_mask"], dtype=bool)
        self.dofmask = _dof_body_mask(A)  # (nbody, nv)
        self.body_iw = _floats(f64["body_invweight0"][:, 0])
        self.geom_body = [int(b) for b in np.asarray(A["geom_bodyid"])]

        # --- Euler's in-kernel implicit damping (:314-329) ---------------
        self.euler_dv = (int(A["opt.integrator"]) == int(IntegratorType.EULER)
                         and not flags & DisableBit.EULERDAMP)
        self.dof_damping = _floats(f64["dof_damping"]) if self.euler_dv \
            else None

        # --- FK tables (pallas_fk.FkPlan) --------------------------------
        tup = lambda x: tuple(float(v) for v in x)  # noqa: E731
        self.body_pos = [tup(f64["body_pos"][b]) for b in range(nb)]
        self.body_quat = [tup(f64["body_quat"][b]) for b in range(nb)]
        self.body_ipos = [tup(f64["body_ipos"][b]) for b in range(nb)]
        self.body_iquat = [tup(f64["body_iquat"][b]) for b in range(nb)]
        jadr, jnum = np.asarray(A["body_jntadr"]), np.asarray(A["body_jntnum"])
        self.body_joints = [
            [dict(j=int(j), q=int(qadr[j]), q0=float(qpos0[qadr[j]]),
                  hinge=int(jt[j]) == int(JointType.HINGE),
                  pos=tup(f64["jnt_pos"][j]), axis=tup(f64["jnt_axis"][j]))
             for j in range(int(jadr[b]), int(jadr[b]) + int(jnum[b]))]
            for b in range(nb)]

        # --- smooth stage (_build_smooth: the joint motors; the muscles
        # are MusclePlan's) ----------------------------------------------
        nu = self.nu
        self.sm_acts = []
        for u in range(nu):
            if int(A["actuator_trntype"][u]) == int(TrnType.TENDON):
                continue
            j = int(A["actuator_trnid"][u, 0])
            self.sm_acts.append(dict(
                u=u, q=int(qadr[j]), v=int(dadr[j]),
                gear=float(f64["actuator_gear"][u, 0]),
                gain=_floats(f64["actuator_gainprm"][u, :3]),
                g_affine=int(A["actuator_gaintype"][u]) == int(GainType.AFFINE),
                bias=_floats(f64["actuator_biasprm"][u, :3]),
                b_affine=int(A["actuator_biastype"][u]) == int(BiasType.AFFINE),
                clo=float(f64["actuator_ctrlrange"][u, 0]),
                chi=float(f64["actuator_ctrlrange"][u, 1]),
                climited=bool(A["actuator_ctrllimited"][u]),
                flo=float(f64["actuator_forcerange"][u, 0]),
                fhi=float(f64["actuator_forcerange"][u, 1]),
                flimited=bool(A["actuator_forcelimited"][u])))
        self._mass = _floats(f64["body_mass"])
        self._inertia = [_floats(r) for r in f64["body_inertia"]]
        self._stiffness = _floats(f64["jnt_stiffness"])
        self._spring_ref = [float(f64["qpos_spring"][q]) for q in qadr]
        self._jnt_dof = [int(v) for v in dadr]
        self._damping = _floats(f64["dof_damping"])
        self._armature = _floats(f64["dof_armature"])
        self._jntadr = [int(x) for x in jadr]
        g = f64["opt.gravity"]
        self.sm_gravity = _floats(np.zeros(3) if flags & DisableBit.GRAVITY
                                  else g)
        self.sm_passive_on = not flags & DisableBit.PASSIVE
        self.sm_actuation_on = not flags & DisableBit.ACTUATION
        self.sm_clampctrl = not flags & DisableBit.CLAMPCTRL
        self._dev = {}
        self.ok = True

        # --- uniform contact statics (_check_uniform) -------------------
        if self.ncon and not self.elliptic:
            self._check_uniform(A, groups, f64)
        # --- mega: FK and collision in the kernel (ColPlan), and the
        # tendon and muscle stage of a non-smooth model (:359-378) ---------
        self.mega = bool(self.uniform and self.fric_uniform and self.ncon
                         and self.ncon <= CON_MAX
                         and self._col_plan(A, groups, mesh_tables, f64))
        # --- mega_ell: FK and the extended collision of every analytic
        # group kind and plane-mesh in the kernel (ColPlanExt, :428-461),
        # for the smooth models of either cone that the plane-only plan
        # refuses ---------------------------------------------------------
        if (not self.mega and self.ncon and self.smooth
                and self.ncon <= CON_MAX):
            self.mega_ell = self._ext_plan(A, groups, mesh_tables, f64)
            self.mega = self.mega_ell
        if self.mega and not self.smooth:
            self.mp = None if joint_dyn else MusclePlan.build(
                L, A, self.dofmask, flags)
            self.smooth_mu = self.mp is not None
            self.mega = self.smooth_mu
        self.act_bounds = act_bounds(self.na, A["actuator_actadr"],
                                     A["actuator_actlimited"],
                                     f64["actuator_actrange"])

    @property
    def mesh(self):
        """The `hopper_collision.MeshPlan` of the mega plan's plane-mesh
        group (its hull tables at any k), or None."""
        if not self.mega:
            return None
        if self.mega_ell:
            return self.ext_mesh["mesh"] if self.ext_mesh else None
        return next((d["mesh"] for d in self.groups if d["kind"] == "mesh"),
                    None)

    def dyn_damping(self) -> "RowPlan":
        """This plan with per-env joint damping: `sm_dyn_damping` and the
        flag DAMP_ROWS set (the kernels read each env's damping row), and
        `euler_dv` off, as the reference's plan has it when dof_damping is
        traced (`:314-329`, `:529-537`). Made once; this plan is left as it
        is."""
        if self.sm_dyn_damping:
            return self
        if self._dyn is None:
            dyn = copy.copy(self)
            dyn.sm_dyn_damping = True
            dyn.euler_dv = False
            dyn.dof_damping = None
            dyn._dev = {}
            self._dyn = dyn
        return self._dyn

    def per_env(self, varied) -> "RowPlan | None":
        """The plan of a model whose leaves `varied` differ from env to env
        (stacked variants, domain randomization), with the reference's
        gates for leaves it cannot take as constants (`_conc` of a traced
        leaf): None where the row plan reads one of them (`ROW_LEAVES`,
        `:92-101`, friction loss `:142`), the staged path with the Newton
        kernel; the non-smooth layout where the smooth stage reads one
        (`SMOOTH_LEAVES`, `:519-530`, its actuator table `:545-549`); the
        generic contact pack where the plane plan's pair parameters vary
        (`PAIR_LEAVES`, `:651-656`); per-env damping rows
        (`dyn_damping`); and no mega path for any of them, whose FK and
        collision plans read the rest (`:359-461`). This plan is left as
        it is; with nothing varied it is the plan."""
        varied = frozenset(varied)
        if not varied:
            return self
        if varied & ROW_LEAVES:
            return None
        out = self.dyn_damping() if "dof_damping" in varied else self
        if varied <= {"dof_damping"}:
            return out
        out = copy.copy(out)
        out._dev, out._launch, out._fused_launch, out._dyn = {}, None, None, \
            None
        out.mega = out.mega_ell = out.smooth_mu = False
        out.mp = None
        if varied & SMOOTH_LEAVES:
            out.smooth = False
        if varied & PAIR_LEAVES:
            out.uniform = out.fric_uniform = False
        return out

    def with_budget(self, iterations: int, ls_iterations: int) -> "RowPlan":
        """This plan with another Newton and line-search budget (the
        kernels take it at launch; the tables do not hold it). This plan
        is left as it is."""
        if (iterations, ls_iterations) == (self.iterations,
                                           self.ls_iterations):
            return self
        out = copy.copy(self)
        out.iterations, out.ls_iterations = iterations, ls_iterations
        out._dyn = None
        return out

    @property
    def nfric(self):
        """Friction components packed per slot: 5 with elliptic cones
        (torsion and rolling rows), else the 2 sliding ones (:745-748)."""
        return 5 if self.elliptic else 2

    @property
    def pack_w(self):
        """Width of the packed per-slot contact input (:750-757)."""
        if not self.ncon:
            return 1
        if self.uniform:
            return 5 + (0 if self.fric_uniform else 2)
        return 24 + self.nfric

    def _check_uniform(self, A, groups, f64):
        plane = int(GeomType.PLANE)
        g1s = set()
        for g in groups:
            if int(g.t1) != plane:
                return
            g1s.update(np.asarray(A["pair_geom1"])[g.pair_ids].tolist())
        if len(g1s) != 1:
            return
        gid = g1s.pop()
        if int(A["geom_bodyid"][gid]) != 0 or self.body_iw[0] != 0.0:
            return  # plane on the world body, whose weight folds out
        sref, simp = f64["pair_solref"], f64["pair_solimp"]
        marg, gap, fric = f64["pair_margin"], f64["pair_gap"], \
            f64["pair_friction"]
        if not (np.all(sref == sref[0]) and np.all(simp == simp[0])
                and np.all(marg == marg[0]) and np.all(gap == gap[0])):
            return
        self.c_solref = _floats(sref[0])
        self.c_solimp = _floats(simp[0])
        self.c_margin = float(marg[0] - gap[0])
        self.fric_uniform = bool(np.all(fric[:, :2] == fric[0, :2]))
        self.c_fric = [float(fric[0, 0]), float(fric[0, 1])]
        self.c_fric5 = _floats(fric[0])
        n = _quat_normal(f64["geom_quat"][gid])
        self.c_frame = [_floats(row) for row in _make_frame(n)]
        self.plane_gid = int(gid)
        self.n = tuple(float(x) for x in n)
        self.pp = tuple(float(x) for x in f64["geom_pos"][gid])
        self.uniform = True

    def _col_plan(self, A, groups, mesh_tables, f64) -> bool:
        """The port's ColPlan (pallas_fk.py:384-528): per group against the
        one plane its kind, budget, slots, offset and margin, per pair its
        geom's body and local pose (and a box's or cylinder's size); a
        plane-mesh group takes its `mesh_tables` at any k, k = P too (the
        mega kernels rank its pairs, as the reference's do). False where
        a group falls outside it."""
        gbody = np.asarray(A["geom_bodyid"])
        gtype = np.asarray(A["geom_type"])
        if int(gtype[self.plane_gid]) != int(GeomType.PLANE):
            return False
        tup = lambda x: tuple(float(v) for v in x)  # noqa: E731
        col = []
        n_mesh = 0
        for g, mk in zip(groups, mesh_tables):
            pid = np.asarray(g.pair_ids)
            desc = dict(kind=None, k=int(g.k), slots=int(g.slots),
                        offset=int(g.offset), margin=float(
                            f64["pair_margin"][pid[0]]))
            solid = {int(GeomType.BOX): "box",
                     int(GeomType.CYLINDER): "cyl"}.get(int(g.t2))
            if solid:
                desc["kind"] = solid
                pg2 = np.asarray(A["pair_geom2"])[pid]
                desc["pairs"] = [dict(gid=int(q), body=int(gbody[q]),
                                      size=tup(f64["geom_size"][q]),
                                      gpos=tup(f64["geom_pos"][q]),
                                      gquat=tup(f64["geom_quat"][q]))
                                 for q in pg2]
            elif int(g.t2) == int(GeomType.MESH):
                n_mesh += 1
                if mk is None or n_mesh > 1 or len(mk.pid) > PAIR_MAX:
                    return False  # the group keeps the staged path
                desc["kind"] = "mesh"
                desc["mesh"] = mk
                desc["pairs"] = [dict(gid=int(q), body=int(gbody[q]),
                                      gpos=tup(f64["geom_pos"][q]),
                                      gquat=tup(f64["geom_quat"][q]))
                                 for q in mk.pg2]
            else:
                return False
            col.append(desc)
        kinds = [d["kind"] for d in col]
        if kinds.count("box") > 1 or kinds.count("cyl") > 1 or any(
                len(d["pairs"]) > 32 for d in col if d["kind"] != "mesh"):
            # one table of each kind; a box or cylinder group's top-K
            # ranks at most a warp of pairs (csrc/mega.cu wtopk)
            return False
        self.groups = col
        return True

    def _ext_plan(self, A, groups, mesh_tables, f64) -> bool:
        """The port's ColPlanExt (pallas_fk.py:1507-1697): per group its
        kind, budget and uniform pair statics (margin, includemargin,
        solref, solimp, the 5 frictions), per candidate pair both geoms'
        ids, bodies, local poses, sizes and static bounding radii (the
        self groups' midphase) and the slot's invweight; one static plane
        on the world body. A plane-mesh group keeps its pairs in its
        `hopper_collision.MeshPlan`'s order (bucket-major; the kernels'
        top-K ranks them at any k, k = P too, first index on ties), so
        that a selected pair's row maps back to its hull's geom, body and
        invweight (the reference's gmap, pallas_fk.py:1755-1766), and its
        hull tables are the plane-only plan's (`ext_mesh`: F_MESH, I_MESH,
        F_VERT). False where a group falls outside it (non-uniform statics
        in a group, several planes, a plane-mesh group without tables
        (a graph-less hull, one past the vertex cap) or a second one, a
        ranked group past the kernels' pair widths)."""
        from .collision import rbound_of

        gbody = np.asarray(A["geom_bodyid"])
        gtype = np.asarray(A["geom_type"])
        gsize = f64["geom_size"]
        # the float32 values the plain collision computes: bounding radii,
        # the slot invweight and includemargin
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        rb = rbound_of(torch.as_tensor(f32(gsize)), gtype).numpy()
        biw = f32(f64["body_invweight0"][:, 0])
        pg1_all, pg2_all = (np.asarray(A["pair_geom1"]),
                            np.asarray(A["pair_geom2"]))
        planes = set()
        col = []
        tup = lambda x: tuple(float(v) for v in x)  # noqa: E731
        for g, mk in zip(groups, mesh_tables):
            kind = EXT_KINDS.get((int(g.t1), int(g.t2)))
            if kind is None:
                return False
            pid = np.asarray(g.pair_ids)
            if kind == EXT_KINDS[(int(GeomType.PLANE), int(GeomType.MESH))]:
                if (mk is None or self.ext_mesh is not None
                        or len(mk.pid) > PAIR_MAX):
                    return False
                pid = np.asarray(mk.pid)  # the kernels' pair order
                self.ext_mesh = dict(
                    kind="mesh", k=int(g.k), offset=int(g.offset), mesh=mk,
                    pairs=[dict(gid=int(q), body=int(gbody[q]),
                                gpos=tup(f64["geom_pos"][q]),
                                gquat=tup(f64["geom_quat"][q]))
                           for q in mk.pg2])
            for name in ("pair_solref", "pair_solimp", "pair_margin",
                         "pair_gap", "pair_friction"):
                arr = f64[name]
                if not np.all(arr[pid] == arr[pid[0]]):
                    return False
            pg1, pg2 = pg1_all[pid], pg2_all[pid]
            if int(g.t1) == int(GeomType.PLANE):
                planes.update(int(x) for x in pg1)
            p0 = int(pid[0])

            def side(gid):
                return [*f64["geom_pos"][gid], *f64["geom_quat"][gid],
                        *gsize[gid], float(rb[gid])]

            col.append(dict(
                kind=kind, k=int(g.k), slots=int(g.slots),
                offset=int(g.offset), condim=int(g.condim),
                statics=[float(f64["pair_margin"][p0]),
                         float(f32(f64["pair_margin"][p0])
                               - f32(f64["pair_gap"][p0])),
                         *f64["pair_solref"][p0], *f64["pair_solimp"][p0],
                         *f64["pair_friction"][p0], 0.0, 0.0],
                ints=[[int(a), int(gbody[a]), int(b), int(gbody[b])]
                      for a, b in zip(pg1, pg2)],
                floats=[[*side(a), *side(b),
                         float(biw[gbody[a]] + biw[gbody[b]]), 0.0]
                        for a, b in zip(pg1, pg2)]))
        if len(planes) > 1 or any(int(gbody[q]) != 0 for q in planes):
            return False
        if any(len(d["ints"]) > 32 for d in col if d["kind"] != 8):
            return False  # the kernel's top-K ranks a warp of pairs
        self.ext = col
        return True

    # ------------------------------------------------------------------
    # packed device tables
    # ------------------------------------------------------------------
    def pack(self):
        """(ints, floats) numpy buffers of the kernels (see the module
        note); the int buffer starts with the header."""
        ints = [np.zeros(len(HEADER), np.int32)]
        flts = []
        n_i, n_f = [len(HEADER)], [0]
        hdr = ints[0]

        def put(name, rows):
            arr = np.asarray(rows, np.float32 if name[0] == "F" else np.int32)
            arr = arr.reshape(-1)
            if name in WIDTH and arr.size % WIDTH[name]:
                raise AssertionError(name)
            if name[0] == "F":
                hdr[H[name]] = n_f[0]
                flts.append(arr)
                n_f[0] += arr.size
            else:
                hdr[H[name]] = n_i[0]
                ints.append(arr)
                n_i[0] += arr.size

        nb, nv = self.nbody, self.nv
        put("F_BODY", [[*self.body_pos[b], *self.body_quat[b],
                        *self.body_ipos[b], *self.body_iquat[b],
                        self._mass[b], *self._inertia[b], self.body_iw[b], 0]
                       for b in range(nb)])
        put("I_BODY", [[self.body_parent[b], max(self._jntadr[b], 0),
                        len(self.body_joints[b]), 0] for b in range(nb)])
        put("I_TOPO", self.topo or [0])
        jrows_f, jrows_i = [], []
        for b in range(nb):
            for jd in self.body_joints[b]:
                j = jd["j"]
                jrows_f.append([*jd["pos"], *jd["axis"], jd["q0"],
                                self._stiffness[j], self._spring_ref[j], 0])
                jrows_i.append([int(jd["hinge"]), jd["q"], self._jnt_dof[j],
                                b])
        order = np.argsort([jd["j"] for b in range(nb)
                            for jd in self.body_joints[b]])
        put("F_JNT", np.asarray(jrows_f)[order])
        put("I_JNT", np.asarray(jrows_i)[order])
        put("F_DOF", [[self._damping[d], self._armature[d]]
                      for d in range(nv)])
        put("I_DOF", self.dof_bodyid)
        put("I_ANC", self.anc.astype(np.int32))
        put("I_DMASK", self.dofmask.astype(np.int32))
        put("F_ACT", [[a["gear"], a["gain"][0], a["clo"], a["chi"], a["flo"],
                       a["fhi"], *a["gain"][1:], *a["bias"], 0]
                      for a in self.sm_acts] or [[0] * 12])
        put("I_ACT", [[a["v"], int(a["climited"]), int(a["flimited"]),
                       a["u"], a["q"], int(a["g_affine"]),
                       int(a["b_affine"]), 0] for a in self.sm_acts]
            or [[0] * 8])
        put("F_EQ", [[*r["data"], *r["solref"], *r["solimp"], r["m2"],
                      r["iw"], self.qpos0[r["q1"]], self.qpos0[r["q2"]]]
                     for r in self.eq] or [[0] * 16])
        put("I_EQ", [[r["q1"], r["v1"], r["q2"], r["v2"]] for r in self.eq]
            or [[0] * 4])
        put("F_FL", [[*r["solref"], *r["solimp"], r["floss"], r["iw"], 0]
                     for r in self.fl] or [[0] * 10])
        put("I_FL", [r["v"] for r in self.fl] or [0])
        put("F_LIM", [[r["lo"], r["hi"], r["margin"], *r["solref"],
                       *r["solimp"], r["iw"], 0] for r in self.lim]
            or [[0] * 12])
        put("I_LIM", [[r["q"], r["v"]] for r in self.lim] or [[0] * 2])
        # contact statics (zero unless uniform), timestep and gravity
        if self.uniform:
            statics = [*self.n, *self.pp, *np.asarray(self.c_frame).ravel(),
                       self.c_margin, *self.c_solref, *self.c_solimp,
                       *self.c_fric]
        else:
            statics = [0.0] * 25
        put("F_CON", [*statics, self.timestep, *self.sm_gravity,
                      self.impratio, 0, 0])
        box, cyl, mesh = (next((d for d in self.groups if d["kind"] == kind),
                               None) for kind in ("box", "cyl", "mesh"))
        mesh = mesh or (self.ext_mesh if self.mega_ell else None)
        # box and cylinder pairs: local pose, size (half extents, or the
        # radius and half-length), the group's margin; body and geom
        for name, grp in (("BOX", box), ("CYL", cyl)):
            put(f"F_{name}", [[*p["gpos"], *p["gquat"], *p["size"],
                               grp["margin"], 0] for p in grp["pairs"]]
                if grp else [[0] * 12])
            put(f"I_{name}", [[p["body"], p["gid"]] for p in grp["pairs"]]
                if grp else [[0] * 2])
        if mesh:
            mk = mesh["mesh"]
            put("F_MESH", [[*p["gpos"], *p["gquat"], *mk.pair_f[i], 0]
                           for i, p in enumerate(mesh["pairs"])])
            put("I_MESH", [[p["body"], p["gid"], *mk.pair_i[i]]
                           for i, p in enumerate(mesh["pairs"])])
            put("F_VERT", mk.flat)
        else:
            put("F_MESH", [[0] * 16])
            put("I_MESH", [[0] * 5])
            put("F_VERT", [0.0])
        put("I_GBODY", self.geom_body)
        mp = self.mp
        if mp is not None:
            put("F_MUS", mp.f_mus)
            put("I_MUS", mp.i_mus)
            put("I_SEG", mp.i_seg)
            put("F_SITE", mp.f_site)
            put("I_SITE", mp.i_site)
        else:
            put("F_MUS", [[0] * 28])
            put("I_MUS", [[0] * 6])
            put("I_SEG", [[0] * 2])
            put("F_SITE", [[0] * 4])
            put("I_SITE", [0])
        put("F_ACTB", np.stack(self.act_bounds, axis=1) if self.na
            else [[0] * 2])
        put("I_ELL", list(self.ell_runs) or [[0] * 3])
        put("I_CON", [[int(d), int(a)] for d, a in zip(self.con_dim,
                                                        self.con_efcadr)]
            or [[0] * 2])
        put("I_SHM", mega_launch(self).table() if self.mega
            else [0] * len(SHM))
        ext = self.ext if self.mega_ell else []
        first, xi, xf = 0, [], []
        for d in ext:
            xi.append([d["kind"], d["k"], d["slots"], len(d["ints"]),
                       d["offset"], first, d["condim"], 0])
            first += len(d["ints"])
        put("I_XGRP", xi or [[0] * 8])
        put("F_XGRP", [d["statics"] for d in ext] or [[0] * 16])
        put("I_XPAIR", [r for d in ext for r in d["ints"]] or [[0] * 4])
        put("F_XPAIR", [r for d in ext for r in d["floats"]] or [[0] * 24])
        flags = ((PASSIVE if self.sm_passive_on else 0)
                 | (ACTUATION if self.sm_actuation_on else 0)
                 | (CLAMPCTRL if self.sm_clampctrl else 0)
                 | (REFSAFE if self.refsafe else 0)
                 | (UNIFORM if self.uniform else 0)
                 | (FRIC_UNIFORM if self.fric_uniform else 0)
                 | (SMOOTH if self.smooth else 0)
                 | (MUSCLE if mp is not None else 0)
                 | (ELLIPTIC if self.elliptic else 0)
                 | (DAMP_ROWS if self.sm_dyn_damping else 0))
        counts = dict(
            NQ=self.nq, NV=nv, NBODY=nb, NJNT=self.njnt, NU=self.nu,
            NE=self.ne, NFL=self.nfl, NL=self.nl, NPAD=self.npad,
            NROWS=self.nrows, NCON=self.ncon, FLAGS=flags,
            NBOX=len(box["pairs"]) if box else 0, KBOX=box["k"] if box else 0,
            OFFBOX=box["offset"] if box else 0,
            NCYL=len(cyl["pairs"]) if cyl else 0, KCYL=cyl["k"] if cyl else 0,
            OFFCYL=cyl["offset"] if cyl else 0,
            NMESH=len(mesh["pairs"]) if mesh else 0,
            KMESH=mesh["k"] if mesh else 0,
            OFFMESH=mesh["offset"] if mesh else 0, PACKW=self.pack_w,
            NMOT=len(self.sm_acts), NA=self.na, NMUS=mp.nmus if mp else 0,
            NELL=len(self.ell_runs), NXGRP=len(ext))
        for k, v in counts.items():
            hdr[H[k]] = v
        return np.concatenate(ints), np.concatenate(flts)

    def tables(self, device) -> tuple:
        """(ints, floats) on `device`, made once per device."""
        key = str(device)
        hit = self._dev.get(key)
        if hit is None:
            ints, flts = self.pack()
            hit = self._dev[key] = (torch.as_tensor(ints, device=device),
                                    torch.as_tensor(flts, device=device))
        return hit

    @property
    def ncon_ell(self) -> int:
        """Elliptic contacts (the slots of `ell_runs`)."""
        return sum(cnt for _, cnt, _ in self.ell_runs)


def _dof_body_mask(A) -> np.ndarray:
    """(nbody, nv) bool: dof d moves body b (support.dof_body_mask)."""
    nb, nv = int(A["nbody"]), int(A["nv"])
    parent = np.asarray(A["body_parentid"])
    dofadr, dofnum = np.asarray(A["body_dofadr"]), np.asarray(A["body_dofnum"])
    anc = np.asarray(A["dof_ancestor_mask"], dtype=bool)
    mask = np.zeros((nb, nv), dtype=bool)
    for b in range(1, nb):
        c = b
        while c > 0 and dofnum[c] == 0:
            c = int(parent[c])
        if c > 0:
            mask[b] = anc[int(dofadr[c]) + int(dofnum[c]) - 1]
    return mask


def act_bounds(na, actadr, actlimited, actrange):
    """(lo, hi) per act slot, -inf / inf where unlimited: the reference's
    `_act_bounds_static` (`:2619-2635`), which the port's leaves always
    give (none is traced)."""
    lo, hi = np.full(na, -np.inf), np.full(na, np.inf)
    for u, adr in enumerate(np.asarray(actadr)):
        if adr >= 0 and actlimited[u]:
            lo[adr], hi[adr] = (float(x) for x in np.asarray(actrange)[u])
    return lo, hi


class MusclePlan:
    """Static tables of the in-kernel tendon and muscle stage, the
    reference's `pallas_fk.MusclePlan` (`:1001-1128`, same field names)
    for site-path tendons driving MUSCLE actuators, and the tables the
    kernels of `csrc/mega.cu` read (`f_mus`, `i_mus`, `i_seg`, `f_site`,
    `i_site`): per muscle its 24 parameters and ctrl / force limits, its
    segments (their range in `i_seg`), its act slot and ctrl index; per
    segment its two sites; per site its body and local position. The
    kernel computes the sites from the body frames and walks the endpoint
    bodies' dof chains (the plan's `dofmask`), so the reference's
    incidence tables (SB, SBo, GA, GB, WA, WB, S_u) are not kept."""

    @classmethod
    def build(cls, L, A, dofmask, flags):
        """The plan, or None where the reference's refuses the model
        (no tendon actuator, or more muscles than `MUS_MAX`)."""
        trn = np.asarray(A["actuator_trntype"])
        mus = np.nonzero(trn == int(TrnType.TENDON))[0]
        if not len(mus) or len(mus) > MUS_MAX or int(A["na"]) > MUS_MAX:
            return None
        return cls(L, A, dofmask, flags, mus)

    def __init__(self, L, A, dofmask, flags, mus):
        from .tendon import site_path_tables

        f64 = {k: np.asarray(L[k], np.float64) for k in (
            "site_pos", "actuator_gear", "actuator_gainprm",
            "actuator_biasprm", "actuator_dynprm", "actuator_lengthrange",
            "actuator_acc0", "actuator_ctrlrange", "actuator_forcerange")}
        site_ids, GA, GB, S, _, _ = site_path_tables(
            A["tendon_site"], A["tendon_sitemask"], A["site_bodyid"], dofmask)
        self.site_ids = [int(s) for s in site_ids]
        spos, gear = f64["site_pos"], f64["actuator_gear"]
        sbody = np.asarray(A["site_bodyid"])[site_ids]
        ns = len(site_ids)
        self.mus = [int(u) for u in mus]
        S_u = S[np.asarray(A["actuator_trnid"])[mus, 0]]
        self.gear = [float(gear[u, 0]) for u in mus]
        self.act_adr = [int(A["actuator_actadr"][u]) for u in mus]
        cr, fr = f64["actuator_ctrlrange"], f64["actuator_forcerange"]
        self.ctrl_lim = [(float(cr[u, 0]), float(cr[u, 1]))
                         if A["actuator_ctrllimited"][u] else None
                         for u in mus]
        self.force_lim = [(float(fr[u, 0]), float(fr[u, 1]))
                          if A["actuator_forcelimited"][u] else None
                          for u in mus]
        # [dyn_tau_act, dyn_tau_deact, gainprm[0:9], biasprm[0:9], lr0,
        #  lr1, acc0, gear] per muscle
        lr, acc0 = f64["actuator_lengthrange"], f64["actuator_acc0"]
        self.prm = np.asarray(
            [[*f64["actuator_dynprm"][u, :2], *f64["actuator_gainprm"][u, :9],
              *f64["actuator_biasprm"][u, :9], lr[u, 0], lr[u, 1], acc0[u],
              gear[u, 0]] for u in mus], np.float32)
        self.nmus, self.nseg, self.ns = len(mus), GA.shape[0], ns
        self.clampctrl = not flags & DisableBit.CLAMPCTRL
        self.actuation_on = not flags & DisableBit.ACTUATION
        # the kernels' tables
        seg_a, seg_b = GA.argmax(axis=1), GB.argmax(axis=1)
        self.i_seg, self.i_mus, self.f_mus = [], [], []
        for i, u in enumerate(mus):
            segs = np.nonzero(S_u[i])[0]
            lim = (self.ctrl_lim[i] or (0.0, 0.0),
                   self.force_lim[i] or (0.0, 0.0))
            self.i_mus.append([len(self.i_seg), len(segs), self.act_adr[i],
                               int(u), int(self.ctrl_lim[i] is not None),
                               int(self.force_lim[i] is not None)])
            self.i_seg.extend([int(seg_a[k]), int(seg_b[k])] for k in segs)
            self.f_mus.append([*self.prm[i], *lim[0], *lim[1]])
        self.f_site = [[*spos[s], 0.0] for s in site_ids]
        self.i_site = [int(b) for b in sbody]


def build_plan(leaves: dict, aux: dict, groups, mesh_tables):
    """The row plan of a model, or None when it is outside the row
    envelope (the staged path with the standalone Newton kernel runs it);
    `mesh_tables` per group its `hopper_collision.mesh_tables` or None."""
    plan = RowPlan(leaves, aux, groups, mesh_tables)
    return plan if plan.ok else None


def maybe_plan(model, data):
    """The row plan for this data, or None: float64 data gets none, as
    the reference's `maybe_plan` refuses it."""
    if model.plan is None or data.qpos.dtype != torch.float32:
        return None
    return model.plan


# ---- launch geometry of the mega kernels (csrc/mega.cu) --------------------
# One warp per env: its state lives in the block's dynamic shared memory,
# laid out per env by `MegaLaunch` from the model's census (the table
# I_SHM, which the kernels read; csrc/mega.cu enum Shm lists SHM in
# order). The widths below are csrc/mega.cu's: NVEC per-dof vectors (enum
# Vec), BODY_W floats per body (enum BodyF), the per-row arrays and lists
# (enum RowA; 4 more arrays for elliptic plans), SLOT_W floats per contact
# slot (enum SlotF) and SEG_W floats per tendon segment (the muscle
# block's scratch).
SHM = ("TOTAL", "VEC", "CDOF", "JNT", "BODY", "M", "L", "J", "ROW", "R",
       "FL", "MU", "SLOT", "MESH", "MUS", "MISC", "NVJ", "RS", "SLOTW",
       "PMAX", "KMAX")
NVEC, BODY_W, SEG_W, MISC_W = 16, 60, 12, 8
CONE_VECS = 11  # one middle-zone cone's J'g and curvature pairs (dim 6)
CONE_SCR = 26  # its zone's terms: w, g, q, sc (6 each), wg, c2
ROW_ARRAYS, ROW_ARRAYS_ELL = 8, 12
SLOT_W, SLOT_W_EXT = 8, 20
# Hopper (H100): shared memory per SM and per block, the runtime's
# reservation per block, and the SM's block and warp limits
SHM_PER_SM, SHM_PER_BLOCK, SHM_RESERVED = 233472, 232448, 1024
BLOCKS_PER_SM, WARPS_PER_SM = 32, 64
ENVS_PER_BLOCK_MAX = 4  # csrc/mega.cu kMaxEnvsPerBlock
# the fewest resident warps (envs) per SM a launch takes. J stays in
# shared memory where the census leaves that many: on the A1-shaped model
# (4 warps per SM with J in shared memory, 7 with J in a global scratch) the
# megastep ran 92.0 against 93.1 ms (NVIDIA H100 80GB HBM3, 700 W,
# tools/megastep_phases.py). A census past the first nv width whose J in
# shared memory would leave fewer (G1 with its arms: 3) keeps J in a per-env
# global scratch instead (`j_global`, the wide kernels' `jrows` operand);
# the collision's and the smooth stage's scratch stay in shared memory
RESIDENT_FLOOR = 4


class WarpLaunch:
    """The launch of a warp-per-env kernel (csrc/warp_core.cuh `Env`): the
    per-env shared layout (offsets in floats of each region of SHM), its
    size, the envs (warps) per block, the resident warps per SM that
    shared memory allows and where the rows' J lives (`j_global`: in a
    global scratch of E x nrows x NVJ floats, `jrows`, rather than in the
    shared region J, which then holds only the scratch that aliases it).
    `kernel` names the kernels in a refusal."""

    kernel = "warp kernels"

    def _fit(self, sizes, extra, nrows, scratch=None):
        """Places `sizes`; where fewer than `RESIDENT_FLOOR` warps would be
        resident and `scratch` is given, keeps J in the global scratch
        (the J region `scratch` floats); raises if that does not fit
        either, naming the regions."""
        self._place(sizes)
        self.j_global = False
        if self.resident_warps < RESIDENT_FLOOR and scratch is not None:
            sizes["J"] = scratch
            self._place(sizes)
            self.j_global = True
        if self.resident_warps < RESIDENT_FLOOR:
            regions = ", ".join(f"{n} {4 * v}" for n, v in sizes.items()
                                if v)
            raise ValueError(
                f"{self.kernel}: {4 * self.env_floats} bytes of shared "
                f"memory per env ({regions}) leave {self.resident_warps} "
                f"resident warps per SM, fewer than {RESIDENT_FLOOR}")
        self.nrows, self.extra, self._jrows, self._tab = nrows, extra, {}, {}

    def jrows(self, E: int, device):
        """The rows' J scratch of E envs on `device` ((E, nrows, NVJ)
        float32, made once and kept for the next launches), or None where
        J lives in shared memory."""
        if not self.j_global:
            return None
        key = (str(device), E)
        if key not in self._jrows:
            self._jrows[key] = torch.empty(
                (E, self.nrows, self.extra["NVJ"]), dtype=torch.float32,
                device=device)
        return self._jrows[key]

    def _place(self, sizes):
        """The regions' offsets, the env's floats and the launch."""
        self.offset, off = {}, 0
        for name in SHM[1:16]:
            if name == "MESH":
                continue
            self.offset[name] = off
            off += -(-sizes[name] // 4) * 4  # 16-byte aligned regions
        self.offset["MESH"] = self.offset["J"]
        self.env_floats = off
        env_bytes = 4 * off
        best = (0, 1)
        for epb in range(1, ENVS_PER_BLOCK_MAX + 1):
            if epb * env_bytes > SHM_PER_BLOCK:
                break
            blocks = min(BLOCKS_PER_SM, WARPS_PER_SM // epb,
                         SHM_PER_SM // (epb * env_bytes + SHM_RESERVED))
            if blocks * epb > best[0]:
                best = (blocks * epb, epb)
        self.resident_warps, self.envs_per_block = best
        self.shared_bytes = self.envs_per_block * env_bytes

    def table(self) -> list:
        """The per-env offsets in SHM order (the I_SHM table)."""
        return ([self.env_floats]
                + [self.offset[n] for n in SHM[1:16]]
                + [self.extra[n] for n in SHM[16:]])

    def tensor(self, device) -> torch.Tensor:
        """`table()` as int32 on `device`, made once per device (the
        launchers' `shm`)."""
        key = str(device)
        if key not in self._tab:
            self._tab[key] = torch.tensor(self.table(), dtype=torch.int32,
                                          device=device)
        return self._tab[key]


def _solve_sizes(nv, nrows, ne, nfl, ncon_ell=0, ell=False) -> dict:
    """The regions (floats) of a warp solve's state: the nv-long vectors,
    M, L (the factor of M, or the Newton direction's H and gradient; for
    elliptic rows in double, with the double solve's x, dx, M (x - asm)
    and M dx), the row arrays and lists, R and the friction-loss bounds,
    the cone coefficients and the decision words (with an elliptic
    contact's cone vectors)."""
    rs = -(-nrows // 4) * 4
    return {"VEC": NVEC * nv, "M": nv * nv,
            "L": 2 * (nv * nv + 5 * nv) if ell else nv * nv + nv,
            "ROW": (ROW_ARRAYS_ELL if ell else ROW_ARRAYS) * rs,
            "R": max(ne + nfl, 1), "FL": max(nfl, 1),
            "MU": max(ncon_ell, 1),
            "MISC": MISC_W + 2 * -(-nrows // 64)
            + (2 * (CONE_VECS * nv + CONE_SCR) if ell else 0)}


class MegaLaunch(WarpLaunch):
    """The mega kernels' launch (see `WarpLaunch`) from a plan's census
    (`mega_census`); the plan's I_SHM table carries it."""

    kernel = "mega kernels"

    def __init__(self, census: dict):
        c = census
        nv, nrows = c["nv"], c["nrows"]
        if nv > NV_MAX:
            raise ValueError(f"mega kernels: nv {nv} > {NV_MAX}")
        nvj = nv | 1  # odd: lanes read J rows without conflicts
        ell, ext = c["ell"], c["ext"]
        pmax, kmax = max(c["pairs"], default=1), max(c["ks"], default=1)
        mus = (2 * c["na"] + c["nmus"] + 6 * c["nbody"]) if c["nmus"] else 1
        # the J region: J; before the rows, the smooth stage's and the
        # muscle block's scratch, then the collision's (MESH)
        scratch = max(12 * nv, SEG_W * c["nseg"], 3 * pmax + 2 * kmax)
        sizes = dict(
            _solve_sizes(nv, nrows, c["ne"], c["nfl"], c["ncon_ell"], ell),
            CDOF=12 * nv, JNT=6 * c["njnt"], BODY=BODY_W * c["nbody"],
            J=max(nrows * nvj, scratch),
            SLOT=c["ncon"] * (SLOT_W_EXT if ext else SLOT_W), MUS=mus)
        # only the wide kernels take the J scratch
        self._fit(sizes, {"NVJ": nvj, "RS": -(-nrows // 4) * 4,
                          "SLOTW": SLOT_W_EXT if ext else SLOT_W,
                          "PMAX": pmax, "KMAX": kmax}, nrows,
                  scratch if nv > NV_WIDTHS[0] else None)


class FusedLaunch(WarpLaunch):
    """The fused kernel's launch (csrc/fused.cu; see `WarpLaunch`) from a
    plan's census (`fused_census`): the mega kernels' regions without FK,
    collision and muscle state, the slot region holding the staged
    collision's contact pack (pack_w floats per slot). J stays in shared
    memory where that leaves `RESIDENT_FLOOR` warps per SM, else in the
    global scratch, at either width."""

    kernel = "fused kernel"

    def __init__(self, census: dict):
        c = census
        nv, nrows = c["nv"], c["nrows"]
        if nv > NV_MAX:
            raise ValueError(f"fused kernel: nv {nv} > {NV_MAX}")
        nvj = nv | 1
        scratch = 12 * nv  # the CRB's and the velocity stage's
        sizes = dict(
            _solve_sizes(nv, nrows, c["ne"], c["nfl"], c["ncon_ell"],
                         c["ell"]),
            CDOF=12 * nv, JNT=6 * c["njnt"], BODY=BODY_W * c["nbody"],
            J=max(nrows * nvj, scratch), SLOT=c["ncon"] * c["pack_w"], MUS=0)
        self._fit(sizes, {"NVJ": nvj, "RS": -(-nrows // 4) * 4,
                          "SLOTW": c["pack_w"], "PMAX": 0, "KMAX": 0},
                  nrows, scratch)


class SolveLaunch(WarpLaunch):
    """The standalone Newton kernel's launch (csrc/newton.cu; see
    `WarpLaunch`) for nv dofs and nrows rows, ne equality and nfl
    friction-loss rows first: the solve's regions alone; J stays in the
    operand, env-major with row stride nv (NVJ)."""

    kernel = "Newton kernel"

    def __init__(self, nv: int, nrows: int, ne: int, nfl: int):
        if nv > NV_MAX:
            raise ValueError(f"Newton kernel: nv {nv} > {NV_MAX}")
        sizes = dict(_solve_sizes(nv, nrows, ne, nfl), CDOF=0, JNT=0,
                     BODY=0, J=0, SLOT=0, MUS=0)
        self._fit(sizes, {"NVJ": nv, "RS": -(-nrows // 4) * 4, "SLOTW": 0,
                          "PMAX": 0, "KMAX": 0}, nrows)


def mega_census(plan) -> dict:
    """The counts of a mega plan that size its per-env state."""
    groups = ([(len(g["pairs"]), g["k"]) for g in plan.groups]
              + [(len(d["ints"]), d["k"])
                 for d in (plan.ext if plan.mega_ell else [])])
    mp = plan.mp
    c = dict(nv=plan.nv, nbody=plan.nbody, njnt=plan.njnt,
             nrows=plan.nrows, ncon=plan.ncon, ne=plan.ne, nfl=plan.nfl,
             ncon_ell=plan.ncon_ell, na=plan.na, nmus=mp.nmus if mp else 0,
             nseg=len(mp.i_seg) if mp else 0)
    c = {k: int(v) for k, v in c.items()}
    return dict(c, ell=bool(plan.mega_ell and plan.elliptic),
                ext=bool(plan.mega_ell), pairs=[int(p) for p, _ in groups],
                ks=[int(k) for _, k in groups])


def mega_launch(plan) -> MegaLaunch:
    """The launch of the mega kernels for a plan with `mega` (raises where
    its state does not fit the card, see `MegaLaunch`); made once."""
    if plan._launch is None:
        plan._launch = MegaLaunch(mega_census(plan))
    return plan._launch


def fused_census(plan) -> dict:
    """The counts of a plan that size the fused kernel's per-env state."""
    c = dict(nv=plan.nv, nbody=plan.nbody, njnt=plan.njnt, nrows=plan.nrows,
             ncon=plan.ncon, ne=plan.ne, nfl=plan.nfl,
             ncon_ell=plan.ncon_ell, pack_w=plan.pack_w)
    return dict({k: int(v) for k, v in c.items()}, ell=bool(plan.elliptic))


def fused_launch(plan) -> FusedLaunch:
    """The fused kernel's launch for a plan (raises where its state does
    not fit the card, see `WarpLaunch`); made once."""
    if plan._fused_launch is None:
        plan._fused_launch = FusedLaunch(fused_census(plan))
    return plan._fused_launch


_SOLVE_LAUNCHES: dict = {}


def solve_launch(nv: int, nrows: int, ne: int, nfl: int) -> SolveLaunch:
    """The standalone Newton kernel's launch for these counts; made once
    per count."""
    key = (nv, nrows, ne, nfl)
    if key not in _SOLVE_LAUNCHES:
        _SOLVE_LAUNCHES[key] = SolveLaunch(*key)
    return _SOLVE_LAUNCHES[key]
