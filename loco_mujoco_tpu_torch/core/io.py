"""Model and state carried into the PyTorch port.

Counterpart of `loco_mujoco_tpu/core/io.py` without its MJCF compiler: the
machine with the card has no `mujoco`, so a model arrives as the numpy
leaves and static aux of the JAX package's `put_model` output, written to
an `.npz` by `save_model_npz` and read back by `load_model_npz`.
`model_from_numpy` is the one converter from those arrays to the port's
`Model`; it also fixes, once, everything the step needs to know statically:
the contact groups and slot layout, which plane-mesh groups run the Hopper
select/top-K kernels, and the row plan of the fused constraint kernel and
the mega path (the reference's static gates).

The port covers the physics step of the torque and muscle humanoids, the
A1 quadruped (torque and position mode) and the bipeds: hinge/slide
joints, joint-transmission actuators with fixed or affine gain, no or
affine bias and no activation or one integrator or filter activation
(FILTEREXACT integrated as FILTER, as the reference does), site-path
spatial tendons (no stiffness, damping or limits) driving MUSCLE actuators
with one activation each, JOINT equalities, friction loss, limits,
pyramidal and elliptic contact cones over every classic analytic pair kind
(plane against sphere, capsule, cylinder, box and mesh; sphere-sphere,
sphere-capsule, sphere-box, capsule-capsule), convex pairs in float32 only
(their slots stay inactive, as in the reference's float32 path), Euler and
RK4. Anything else raises `NotImplementedError` here, at load, rather than
deep inside a step.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .types import (
    BiasType,
    Contact,
    Data,
    DynType,
    EqType,
    GainType,
    IntegratorType,
    JointType,
    Model,
    Option,
    TrnType,
)

_OPT_LEAVES = ("timestep", "gravity", "impratio")
_OPT_STATIC = ("integrator", "cone", "iterations", "ls_iterations",
               "disableflags", "tolerance", "ls_tolerance")
_PORT_ONLY = ("groups", "ncon", "mesh_kernel", "plan", "cache", "varied",
              "env_id", "geom_shape")
# Leaves a stage reads per env where they vary (`Model.varied`), by the
# stage that reads them: kinematics and com_pos; crb and the fused
# kernel's non-smooth vector; passive; actuation; collision (mesh_vert
# through each env's hull table, `hopper_collision.mesh_slots` with K
# tables); make_constraint.
PER_ENV = frozenset({
    "body_pos", "body_quat", "body_ipos", "body_iquat", "jnt_pos",
    "geom_pos", "geom_quat", "site_pos", "site_quat",
    "body_mass", "body_inertia", "dof_armature",
    "jnt_stiffness", "qpos_spring", "dof_damping",
    "actuator_gear", "actuator_gainprm", "actuator_biasprm",
    "actuator_lengthrange", "actuator_acc0",
    "geom_size", "geom_rbound", "mesh_vert", "pair_margin", "pair_gap",
    "pair_friction", "pair_solref", "pair_solimp",
    "dof_invweight0", "body_invweight0", "dof_frictionloss"})
# Leaves no stage of the step reads (the pair tables carry the contacts'
# parameters, and tendon springs are refused at load): where they vary,
# nothing changes, here as in the reference.
UNREAD = frozenset({
    "geom_friction", "geom_margin", "geom_gap", "geom_solref",
    "geom_solimp", "geom_solmix", "actuator_length0", "tendon_invweight0",
    "tendon_lengthspring"})


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one. With no card and no explicit request this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run the plain versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def model_field_names():
    """(numeric leaf names, static aux names) of `Model`, with the option
    fields spelled `opt.<name>` — the keys of the carried-over arrays."""
    leaves = [f"opt.{n}" for n in _OPT_LEAVES]
    aux = [f"opt.{n}" for n in _OPT_STATIC]
    for f in dataclasses.fields(Model):
        if f.name == "opt" or f.name in _PORT_ONLY:
            continue
        (aux if f.metadata.get("static") else leaves).append(f.name)
    return leaves, aux


def save_model_npz(path, leaves: dict, aux: dict) -> None:
    """Write carried-over model arrays as one compressed `.npz`."""
    arrays = {f"leaf:{k}": np.asarray(v) for k, v in leaves.items()}
    meta = {"scalars": {}, "names": None, "mesh_nbr": []}
    for k, v in aux.items():
        if k == "names":
            meta["names"] = v
        elif k == "mesh_nbr":
            for i, t in enumerate(v):
                meta["mesh_nbr"].append(t is not None)
                if t is not None:
                    arrays[f"aux:mesh_nbr:{i}"] = np.asarray(t)
        elif isinstance(v, np.ndarray):
            arrays[f"aux:{k}"] = v
        else:
            meta["scalars"][k] = v.item() if isinstance(v, np.generic) else v
    arrays["meta"] = np.asarray(json.dumps(meta, sort_keys=True))
    np.savez_compressed(path, **arrays)


def read_model_npz(path):
    """(leaves, aux) dicts of numpy arrays / python values from an `.npz`
    written by `save_model_npz`."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        leaves, aux = {}, dict(meta["scalars"])
        for key in z.files:
            if key.startswith("leaf:"):
                leaves[key[5:]] = z[key]
            elif key.startswith("aux:") and not key.startswith("aux:mesh_nbr:"):
                aux[key[4:]] = z[key]
        aux["mesh_nbr"] = tuple(
            z[f"aux:mesh_nbr:{i}"] if has else None
            for i, has in enumerate(meta["mesh_nbr"])
        )
    aux["names"] = meta["names"]
    return leaves, aux


def _check_supported(aux: dict, dtype) -> None:
    """Raise NotImplementedError for features outside this slice."""
    jt = np.asarray(aux["jnt_type"])
    if not np.all((jt == int(JointType.HINGE)) | (jt == int(JointType.SLIDE))):
        raise NotImplementedError("hinge/slide joints only")
    if int(aux["ntendon"]):
        # the JAX package's put_model encodes site paths only (it refuses
        # wrap geoms); a path of fewer than two sites is no site path
        mask = np.asarray(aux["tendon_sitemask"], dtype=bool)
        if np.any(mask.sum(axis=1) < 2):
            raise NotImplementedError(
                "site-path spatial tendons only (wrap geoms are not ported)")
        for name in ("tendon_stiffness", "tendon_damping"):
            if np.any(np.asarray(aux[name]) != 0):
                raise NotImplementedError(f"{name} is not ported yet")
        if np.any(np.asarray(aux["tendon_limited"])):
            raise NotImplementedError("tendon limits are not ported yet")
    nu = int(aux["nu"])
    if nu:
        trn = np.asarray(aux["actuator_trntype"])
        dyn, gain, bias = (np.asarray(aux[f"actuator_{k}type"])
                           for k in ("dyn", "gain", "bias"))
        one_act = ((np.asarray(aux["actuator_actadr"]) >= 0)
                   & (np.asarray(aux["actuator_actnum"]) == 1))
        # joint transmissions: fixed or affine gain, no or affine bias, no
        # activation or one integrator / filter activation (the reference
        # integrates FILTEREXACT as FILTER)
        joint = (np.isin(trn, [int(TrnType.JOINT), int(TrnType.JOINTINPARENT)])
                 & np.isin(gain, [int(GainType.FIXED), int(GainType.AFFINE)])
                 & np.isin(bias, [int(BiasType.NONE), int(BiasType.AFFINE)])
                 & ((dyn == int(DynType.NONE))
                    | (np.isin(dyn, [int(DynType.INTEGRATOR),
                                     int(DynType.FILTER),
                                     int(DynType.FILTEREXACT)]) & one_act)))
        muscle = ((trn == int(TrnType.TENDON)) & (dyn == int(DynType.MUSCLE))
                  & (gain == int(GainType.MUSCLE))
                  & (bias == int(BiasType.MUSCLE)) & one_act)
        if not np.all(joint | muscle):
            raise NotImplementedError(
                "joint actuators (fixed or affine gain, no or affine bias, "
                "no activation or one integrator or filter activation) and "
                "tendon muscles are the only actuators ported")
    from ..ops.collision import CONVEX_SLOTS

    pair_types = {(int(aux["geom_type"][a]), int(aux["geom_type"][b]))
                  for a, b in zip(aux["pair_geom1"], aux["pair_geom2"])}
    if dtype == torch.float64 and any(
            t in CONVEX_SLOTS or t[::-1] in CONVEX_SLOTS for t in pair_types):
        raise NotImplementedError(
            "convex (GJK) contact pairs are not ported: float32 leaves their "
            "slots inactive, as the reference's plans do; float64 would "
            "need GJK")
    if int(aux["opt.integrator"]) not in (int(IntegratorType.EULER),
                                          int(IntegratorType.RK4)):
        raise NotImplementedError("Euler and RK4 are the integrators ported")
    active_eq = np.asarray(aux["eq_active0"], dtype=bool)
    if np.any(np.asarray(aux["eq_type"])[active_eq] != int(EqType.JOINT)):
        raise NotImplementedError("JOINT equalities are the only ones ported")


def model_from_numpy(leaves: dict, aux: dict, device=None,
                     dtype=torch.float32, variants=None) -> Model:
    """Build the port's `Model` from the JAX package's model as numpy.

    leaves: numeric leaves by field name (option leaves as `opt.<name>`);
    aux: static fields by name (`mesh_nbr` a tuple of tables or None,
    `names` a dict). Floating leaves are cast to `dtype` on `device`.
    `variants`: the leaves of more models of this structure (`aux`); the
    model is then the stack of `leaves` and theirs (`stack_variants`)."""
    from ..ops import collision, hopper_collision, plan

    device = resolve_device(device)
    if variants:
        return stack_variants([model_from_numpy(v, aux, device, dtype)
                               for v in (leaves, *variants)])[0]
    _check_supported(aux, dtype)

    def t(x):
        x = np.array(x)  # a writable copy: the tensor owns its memory
        if np.issubdtype(x.dtype, np.floating):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return torch.as_tensor(x, device=device)

    opt = Option(
        **{n: t(leaves[f"opt.{n}"]) for n in _OPT_LEAVES},
        **{n: aux[f"opt.{n}"] for n in _OPT_STATIC},
    )
    leaf_names, aux_names = model_field_names()
    kw = {n: t(leaves[n]) for n in leaf_names if not n.startswith("opt.")}
    kw.update({n: aux[n] for n in aux_names if not n.startswith("opt.")})
    groups, ncon = collision.contact_groups(
        aux["pair_geom1"], aux["pair_geom2"], aux["pair_condim"],
        aux["geom_type"], int(aux["contact_k_plane"]),
        int(aux["contact_k_other"]),
    )
    # each plane-mesh group's hull tables at any budget (the mega plans'),
    # and the staged kernels' plan where the group ranks its pairs (k < P)
    mesh_tables = tuple(
        hopper_collision.mesh_tables(leaves, aux, g)
        if collision.is_plane_mesh(g) else None
        for g in groups
    )
    mesh_kernel = tuple(hopper_collision.staged_plan(g, t)
                        for g, t in zip(groups, mesh_tables))
    shape = None
    if "geom_shape_volume" in aux:
        shape = (np.asarray(aux["geom_shape_volume"], np.float64),
                 np.asarray(aux["geom_shape_inertia"], np.float64))
    return Model(opt=opt, groups=tuple(groups), ncon=ncon,
                 mesh_kernel=mesh_kernel, geom_shape=shape,
                 plan=plan.build_plan(leaves, aux, groups, mesh_tables), **kw)


def check_per_env(names) -> None:
    """Raise for a varying leaf that no stage reads per env (`PER_ENV`),
    naming it: nothing may silently take one env's value for all."""
    bad = sorted(set(names) - PER_ENV - UNREAD)
    if bad:
        raise NotImplementedError(
            f"leaves {bad} differ from env to env, and no stage of the "
            f"port reads them per env")


def _same_static(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_static(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same_static(x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


def _field(model: Model, name: str):
    """A field by its carried-over name (option fields as `opt.<name>`)."""
    if name.startswith("opt."):
        return getattr(model.opt, name[4:])
    return getattr(model, name)


def stack_variants(models) -> tuple:
    """(stacked Model, the set of leaves that differ) of K models of one
    structure (the JAX env's `model_variants`, envs/base.py:117-135):
    every variant takes the first's Newton and line-search budgets and
    `stat_meaninertia`; a leaf that differs between them is stacked on a
    leading K axis and named in `varied`, the others keep the first's.
    The stack's plane-mesh kernel plans hold one hull table per variant
    (`hopper_collision.stack_plans`), and its row plan is the first's
    with the reference's gate for those leaves (`RowPlan.per_env`).
    Raises where the models differ in structure (static tables, shapes)
    or in a leaf that no stage reads per env."""
    from ..ops import hopper_collision

    models = list(models)
    if len(models) < 2:
        raise ValueError("stack_variants takes two or more models")
    base = models[0]
    leaf_names, aux_names = model_field_names()
    budget = ("opt.iterations", "opt.ls_iterations", "stat_meaninertia")
    for i, m in enumerate(models[1:], 1):
        for n in aux_names:
            if n not in budget and not _same_static(_field(base, n),
                                                    _field(m, n)):
                raise ValueError(
                    f"variant {i} differs from variant 0 in its structure "
                    f"({n})")
        for n in leaf_names:
            if _field(base, n).shape != _field(m, n).shape:
                raise ValueError(f"variant {i} differs from variant 0 in "
                                 f"the shape of {n}")
        if not _same_static(m.groups, base.groups) or m.ncon != base.ncon:
            raise ValueError(f"variant {i} differs from variant 0 in its "
                             f"contact groups")
    varied = frozenset(
        n for n in leaf_names
        if any(not torch.equal(_field(base, n), _field(m, n))
               for m in models[1:]))
    check_per_env(varied)
    kw = {n: torch.stack([getattr(m, n) for m in models])
          for n in varied}
    mesh_kernel = tuple(
        None if p is None else hopper_collision.stack_plans(
            [m.mesh_kernel[i] for m in models])
        for i, p in enumerate(base.mesh_kernel))
    plan = None if base.plan is None else base.plan.per_env(varied)
    stacked = base.replace(varied=varied, mesh_kernel=mesh_kernel, plan=plan,
                           cache={}, **kw)
    return stacked, varied


def model_at(model: Model, env_id: torch.Tensor) -> Model:
    """The per-env model of a batch of envs of stacked variants: each
    varied leaf's row of each env's variant, (E, ...) (the JAX env's
    `_model_at`, envs/base.py:262-265), but `mesh_vert`, which keeps its
    variant axis and is read through `env_id` (see core/types.py)."""
    env_id = env_id.to(device=model.qpos0.device, dtype=torch.int64)
    kw = {n: getattr(model, n)[env_id] for n in model.varied
          if n != "mesh_vert"}
    return model.replace(env_id=env_id, **kw)


def load_model_npz(path, device=None, dtype=torch.float32) -> Model:
    """Load a model written by `save_model_npz` onto `device` (the card
    unless the caller passes another device)."""
    leaves, aux = read_model_npz(path)
    return model_from_numpy(leaves, aux, device=device, dtype=dtype)


def make_data(model: Model, n_envs: int) -> Data:
    """Fresh Data of `n_envs` envs at qpos0 (mj_resetData, before forward),
    on the model's device and in its dtype."""
    dt, dev = model.qpos0.dtype, model.qpos0.device
    E = int(n_envs)
    nq, nv, nu, na = model.nq, model.nv, model.nu, model.na
    nbody, njnt, ngeom = model.nbody, model.njnt, model.ngeom
    nsite, ntendon, nc = model.nsite, model.ntendon, model.ncon

    def z(*shape):
        return torch.zeros((E, *shape), dtype=dt, device=dev)

    def eye(n):
        return torch.eye(3, dtype=dt, device=dev).expand(E, n, 3, 3).clone()

    def tile(vals, n):
        v = torch.tensor(vals, dtype=dt, device=dev)
        return v.expand(E, n, len(vals)).clone()

    contact = Contact(
        dist=torch.full((E, nc), 1e10, dtype=dt, device=dev),
        pos=z(nc, 3),
        frame=eye(nc),
        includemargin=z(nc),
        friction=tile([1, 1, 0.005, 1e-4, 1e-4], nc),
        solref=tile([0.02, 1.0], nc),
        solimp=tile([0.9, 0.95, 0.001, 0.5, 2.0], nc),
        geom1=torch.zeros((E, nc), dtype=torch.int64, device=dev),
        geom2=torch.zeros((E, nc), dtype=torch.int64, device=dev),
        dim=np.ones(nc, dtype=np.int32),
    )
    return Data(
        qpos=model.qpos0.expand(E, nq).clone(),
        qvel=z(nv), act=z(na), ctrl=z(nu), qacc=z(nv), qacc_warmstart=z(nv),
        time=torch.zeros(E, dtype=dt, device=dev),
        xpos=z(nbody, 3), xquat=tile([1.0, 0, 0, 0], nbody), xmat=eye(nbody),
        xipos=z(nbody, 3), ximat=eye(nbody),
        xanchor=z(njnt, 3), xaxis=z(njnt, 3),
        geom_xpos=z(ngeom, 3), geom_xmat=eye(ngeom),
        site_xpos=z(nsite, 3), site_xmat=eye(nsite),
        subtree_com=z(nbody, 3), cinert=z(nbody, 10), cdof=z(nv, 6),
        qM=z(nv, nv), qLD=z(nv, nv),
        ten_length=z(ntendon), ten_J=z(ntendon, nv),
        contact=contact,
        cvel=z(nbody, 6), cdof_dot=z(nv, 6), qfrc_bias=z(nv),
        ten_velocity=z(ntendon),
        actuator_length=z(nu), actuator_velocity=z(nu), actuator_force=z(nu),
        act_dot=z(na), qfrc_actuator=z(nv),
        qfrc_passive=z(nv), qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
        qfrc_smooth=z(nv), qacc_smooth=z(nv), qfrc_constraint=z(nv),
        efc_force_contact=z(nc, 10),
        solver_niter=torch.zeros(E, dtype=torch.int32, device=dev),
        solver_taken=torch.zeros(E, dtype=torch.int32, device=dev),
        solver_ls=torch.zeros((E, 4), dtype=torch.int32, device=dev),
    )
