"""Core containers of the PyTorch port of the physics engine.

Counterpart of `loco_mujoco_tpu/core/types.py`, with the same field names so
that a test can compare the two packages field by field. `Model` holds one
robot's constants: numeric fields are tensors without an env axis, and
structural fields are numpy arrays or python objects (`static_field`).
`Data` is the state of E environments: every tensor carries a leading env
axis E, the axis `jax.vmap` added in the JAX package.

The port adds five structural fields to `Model`, all fixed when the model
is loaded (`core/io.py`): the contact groups and slot count of
`ops/collision.py`, the per-group plan of the plane-mesh Hopper kernels
(None where the reference keeps its XLA path), the row plan of the fused
constraint kernel and the mega path (`ops/plan.py`; None outside its
envelope), and a cache of static index tables.

Leaves that differ from env to env (stacked model variants, domain
randomization) are named in `Model.varied`. In a model of stacked variants
(`io.stack_variants`) such a leaf carries a leading variant axis K; in the
per-env model of a batch (`io.model_at`, the env layer) a leading env axis
E, so that every stage reads its env's row. `mesh_vert` is the exception:
it keeps its variant axis in both, and the per-env model's `env_id` (E,)
picks each env's row where a stage reads it (`ops/collision.py`, and the
per-variant hull tables of `ops/hopper_collision.py`). A leaf that does
not vary keeps its shape, as in the JAX package. `geom_shape`, where a
committed stand-in carries it, holds the unit-density shape constants of
its primitive geoms, which the Geoms section's mass and density
randomization needs (`utils/domain_randomization.py`).
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np
import torch

from .struct import static_field, tensor_dataclass


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class TrnType(enum.IntEnum):
    JOINT = 0
    JOINTINPARENT = 1
    SLIDERCRANK = 2
    TENDON = 3
    SITE = 4


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class IntegratorType(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3


class DisableBit(enum.IntFlag):
    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    PASSIVE = 1 << 5
    GRAVITY = 1 << 6
    CLAMPCTRL = 1 << 7
    ACTUATION = 1 << 10
    REFSAFE = 1 << 11
    EULERDAMP = 1 << 14


@tensor_dataclass
class Option:
    """Physics options (the subset of mjOption the robots use)."""

    timestep: torch.Tensor
    gravity: torch.Tensor  # (3,)
    impratio: torch.Tensor
    integrator: int = static_field(default=int(IntegratorType.EULER))
    cone: int = static_field(default=int(ConeType.PYRAMIDAL))
    iterations: int = static_field(default=100)
    ls_iterations: int = static_field(default=50)
    disableflags: int = static_field(default=0)
    tolerance: float = static_field(default=1e-8)
    ls_tolerance: float = static_field(default=0.01)


@tensor_dataclass
class Model:
    """One robot: numeric tensors (no env axis) plus structural aux."""

    opt: Option

    # --- numeric leaves ----------------------------------------------------
    qpos0: torch.Tensor
    qpos_spring: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_range: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_solref: torch.Tensor
    jnt_solimp: torch.Tensor
    jnt_margin: torch.Tensor
    dof_damping: torch.Tensor
    dof_armature: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_solref: torch.Tensor
    dof_solimp: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_rbound: torch.Tensor
    geom_friction: torch.Tensor
    geom_margin: torch.Tensor
    geom_gap: torch.Tensor
    geom_solref: torch.Tensor
    geom_solimp: torch.Tensor
    geom_solmix: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    actuator_gear: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor
    actuator_actrange: torch.Tensor
    actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_dynprm: torch.Tensor
    actuator_length0: torch.Tensor
    actuator_lengthrange: torch.Tensor
    actuator_acc0: torch.Tensor
    eq_data: torch.Tensor
    eq_solref: torch.Tensor
    eq_solimp: torch.Tensor
    mesh_vert: torch.Tensor
    body_invweight0: torch.Tensor
    dof_invweight0: torch.Tensor
    tendon_invweight0: torch.Tensor
    pair_friction: torch.Tensor
    pair_solref: torch.Tensor
    pair_solimp: torch.Tensor
    pair_margin: torch.Tensor
    pair_gap: torch.Tensor
    tendon_lengthspring: torch.Tensor

    # --- structural fields -------------------------------------------------
    mesh_vertmask: np.ndarray = static_field()
    mesh_nbr: tuple = static_field()
    mesh_brute: np.ndarray = static_field()
    nq: int = static_field(default=0)
    nv: int = static_field(default=0)
    nu: int = static_field(default=0)
    na: int = static_field(default=0)
    nbody: int = static_field(default=0)
    njnt: int = static_field(default=0)
    ngeom: int = static_field(default=0)
    nsite: int = static_field(default=0)
    ntendon: int = static_field(default=0)
    neq: int = static_field(default=0)
    body_parentid: np.ndarray = static_field(default=None)
    dof_parentid: np.ndarray = static_field(default=None)
    dof_ancestor_mask: np.ndarray = static_field(default=None)
    dof_frictionloss0: np.ndarray = static_field(default=None)
    stat_meaninertia: float = static_field(default=1.0)
    contact_k_plane: int = static_field(default=8)
    contact_k_other: int = static_field(default=4)
    tendon_range: np.ndarray = static_field(default=None)
    tendon_limited: np.ndarray = static_field(default=None)
    tendon_stiffness: np.ndarray = static_field(default=None)
    tendon_damping: np.ndarray = static_field(default=None)
    tendon_solref_lim: np.ndarray = static_field(default=None)
    tendon_solimp_lim: np.ndarray = static_field(default=None)
    tendon_margin: np.ndarray = static_field(default=None)
    body_rootid: np.ndarray = static_field(default=None)
    body_weldid: np.ndarray = static_field(default=None)
    body_jntadr: np.ndarray = static_field(default=None)
    body_jntnum: np.ndarray = static_field(default=None)
    body_dofadr: np.ndarray = static_field(default=None)
    body_dofnum: np.ndarray = static_field(default=None)
    jnt_type: np.ndarray = static_field(default=None)
    jnt_bodyid: np.ndarray = static_field(default=None)
    jnt_qposadr: np.ndarray = static_field(default=None)
    jnt_dofadr: np.ndarray = static_field(default=None)
    jnt_limited: np.ndarray = static_field(default=None)
    jnt_actfrclimited: np.ndarray = static_field(default=None)
    dof_bodyid: np.ndarray = static_field(default=None)
    dof_jntid: np.ndarray = static_field(default=None)
    geom_type: np.ndarray = static_field(default=None)
    geom_bodyid: np.ndarray = static_field(default=None)
    geom_condim: np.ndarray = static_field(default=None)
    geom_priority: np.ndarray = static_field(default=None)
    geom_meshid: np.ndarray = static_field(default=None)
    site_bodyid: np.ndarray = static_field(default=None)
    actuator_trntype: np.ndarray = static_field(default=None)
    actuator_trnid: np.ndarray = static_field(default=None)
    actuator_dyntype: np.ndarray = static_field(default=None)
    actuator_gaintype: np.ndarray = static_field(default=None)
    actuator_biastype: np.ndarray = static_field(default=None)
    actuator_actadr: np.ndarray = static_field(default=None)
    actuator_actnum: np.ndarray = static_field(default=None)
    actuator_ctrllimited: np.ndarray = static_field(default=None)
    actuator_forcelimited: np.ndarray = static_field(default=None)
    actuator_actlimited: np.ndarray = static_field(default=None)
    tendon_site: np.ndarray = static_field(default=None)
    tendon_sitemask: np.ndarray = static_field(default=None)
    eq_type: np.ndarray = static_field(default=None)
    eq_obj1id: np.ndarray = static_field(default=None)
    eq_obj2id: np.ndarray = static_field(default=None)
    eq_active0: np.ndarray = static_field(default=None)
    pair_geom1: np.ndarray = static_field(default=None)
    pair_geom2: np.ndarray = static_field(default=None)
    pair_condim: np.ndarray = static_field(default=None)
    names: Any = static_field(default=None)

    # --- port-only structure, fixed at load (core/io.py) -------------------
    groups: tuple = static_field(default=())  # collision.Group per group
    ncon: int = static_field(default=0)  # total contact slots
    mesh_kernel: tuple = static_field(default=())  # per group: plan or None
    plan: Any = static_field(default=None)  # plan.RowPlan or None
    cache: dict = static_field(default_factory=dict, compare=False)
    # leaves with a leading variant (K) or env (E) axis (see the module note)
    varied: frozenset = static_field(default=frozenset())
    # (E,) int64 variant of each env in a per-env model of variants, or None
    env_id: Any = None
    # (volume (ngeom,), inertia (ngeom, 3, 3)): each primitive geom's
    # volume at unit density and inertia at unit mass about its center in
    # its body's frame (NaN for other geoms), or None
    geom_shape: Any = static_field(default=None)


@tensor_dataclass
class Contact:
    """All contact slots of E envs, fixed shape (E, ncon, ...)."""

    dist: torch.Tensor  # (E, ncon)
    pos: torch.Tensor  # (E, ncon, 3)
    frame: torch.Tensor  # (E, ncon, 3, 3) rows: normal, tangent1, tangent2
    includemargin: torch.Tensor  # (E, ncon)
    friction: torch.Tensor  # (E, ncon, 5)
    solref: torch.Tensor  # (E, ncon, 2)
    solimp: torch.Tensor  # (E, ncon, 5)
    geom1: torch.Tensor  # (E, ncon) int64
    geom2: torch.Tensor  # (E, ncon) int64
    dim: np.ndarray = static_field(default=None)  # condim per slot


@tensor_dataclass
class Data:
    """Dynamic state of E envs: every tensor has a leading env axis."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    qacc: torch.Tensor
    qacc_warmstart: torch.Tensor
    time: torch.Tensor  # (E,)

    xpos: torch.Tensor
    xquat: torch.Tensor
    xmat: torch.Tensor
    xipos: torch.Tensor
    ximat: torch.Tensor
    xanchor: torch.Tensor
    xaxis: torch.Tensor
    geom_xpos: torch.Tensor
    geom_xmat: torch.Tensor
    site_xpos: torch.Tensor
    site_xmat: torch.Tensor
    subtree_com: torch.Tensor
    cinert: torch.Tensor
    cdof: torch.Tensor
    qM: torch.Tensor
    qLD: torch.Tensor
    ten_length: torch.Tensor
    ten_J: torch.Tensor
    contact: Contact

    cvel: torch.Tensor
    cdof_dot: torch.Tensor
    qfrc_bias: torch.Tensor
    ten_velocity: torch.Tensor

    actuator_length: torch.Tensor
    actuator_velocity: torch.Tensor
    actuator_force: torch.Tensor
    act_dot: torch.Tensor
    qfrc_actuator: torch.Tensor

    qfrc_passive: torch.Tensor
    qfrc_applied: torch.Tensor
    xfrc_applied: torch.Tensor
    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    qfrc_constraint: torch.Tensor
    efc_force_contact: torch.Tensor  # (E, ncon, 10)
    # Newton iterations each env ran in the last solve (mjData.solver_niter)
    # and that solve's discrete decisions (bit i: step i was taken; bit 31:
    # it started at the warm start; and the line search's, bit
    # it * ls_iterations + j: phi' < 0 at its trial j of step it), which a
    # plain solve can replay; not in the JAX package's Data
    solver_niter: torch.Tensor  # (E,) int32
    solver_taken: torch.Tensor  # (E,) int32
    solver_ls: torch.Tensor  # (E, 4) int32
    # Euler's implicit-damping velocity change (M + dt diag(damping))^-1
    # M qacc, written by the kernels of a plan with `euler_dv`; None where
    # the integrator solves it from qM (the JAX package's Data.euler_dv)
    euler_dv: torch.Tensor | None = None
    # the last solve's Hessian decision of every row at each Newton step
    # (E, iterations, row words) int32 (hopper_newton.row_bits), written by
    # the fused and mega kernels and their plain versions; None elsewhere
    solver_rows: torch.Tensor | None = None
    # each env's joint damping (E, nv) where it is domain-randomized
    # (envs/base.py `_apply_dr`), read by passive, Euler's implicit damping
    # and the kernels of a plan's `dyn_damping()` variant in place of
    # Model.dof_damping; None where every env has the model's (the JAX
    # package carries it as a per-env Model leaf under vmap)
    dof_damping: torch.Tensor | None = None
