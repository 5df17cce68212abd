"""Domain randomization: per-env draws of the Joints section's model leaves.

Counterpart of `loco_mujoco_tpu/utils/domain_randomization.py` for the
reference YAML schema's Joints section (reference
`loco_mujoco/utils/domain_randomization.py:244-377`). The config is a
parsed dict (`load_config` reads a YAML file, importing PyYAML only
there):

- a `Default` section with an optional `exclude` joint list and a `Joints`
  subsection applied to every joint; a joint's own `Joints` entry
  *overrides* the default (the reference dispatches specific-elif-default,
  :267-294); `exclude` filters the default only (:272-274);
- `Joints` properties: damping, stiffness, frictionloss, armature
  (`_JOINT_FIELDS`, set_joint_conf :299-377);
- distributions: `sigma`, N(base, sigma) clipped to >= 0; `uniform_range`,
  U(lo, hi); `uniform_range_delta`, U(base - d, base + d), positivity
  checked at build.

`sample(generator, n_envs)` draws every env's values from an explicit
`torch.Generator`; `apply(model, samples)` scatters them into per-env
copies of the leaves, (E, *leaf shape), which the env layer hands to the
kernels (`Data.dof_damping`) instead of a per-env Model. The `Geoms` and
`Inertial` sections need MuJoCo at build (the JAX package measures each
geom's shape constants by compiling a micro-model) and per-env body and
geom leaves on the staged path: a config that uses them raises
`NotImplementedError` (ROADMAP Queue 1 #2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Model

# distribution codes
GAUSS = 0
UNIFORM = 1
UNIFORM_DELTA = 2

_JOINT_FIELDS = {
    "damping": ("dof_damping", "dof"),
    "stiffness": ("jnt_stiffness", "jnt"),
    "frictionloss": ("dof_frictionloss", "dof"),
    "armature": ("dof_armature", "dof"),
}


def load_config(path) -> dict:
    """A YAML randomization config as a dict (PyYAML, imported here)."""
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def _dist_params(param: dict, base, name: str, prop: str):
    """One YAML distribution spec as (code, p1, p2) arrays broadcast to
    base's shape, validated like the reference's check_* helpers."""
    base = np.atleast_1d(np.asarray(base, dtype=np.float64))
    keys = {"sigma", "uniform_range", "uniform_range_delta"} & set(param)
    if len(keys) != 1:
        raise ValueError(
            f"exactly one distribution must be given for {name}.{prop}, "
            f"found {sorted(param)}")
    if "sigma" in param:
        sig = np.broadcast_to(np.asarray(param["sigma"], dtype=np.float64),
                              base.shape)
        return GAUSS, sig, np.zeros_like(base)
    if "uniform_range" in param:
        lo, hi = param["uniform_range"]
        if not hi > lo:
            raise ValueError(f"uniform_range for {name}.{prop}: high <= low")
        if lo < 0.0:
            raise ValueError(f"uniform_range for {name}.{prop}: low < 0")
        return (UNIFORM, np.full_like(base, float(lo)),
                np.full_like(base, float(hi)))
    d = np.broadcast_to(
        np.asarray(param["uniform_range_delta"], dtype=np.float64), base.shape)
    if np.any(d != 0.0) and np.any(base - d <= 0.0):
        raise ValueError(
            f"uniform_range_delta for {name}.{prop} exceeds the base value "
            f"({base}); negative physics parameters are not allowed")
    return UNIFORM_DELTA, d.copy(), np.zeros_like(base)


class DomainRandomizationHandler:
    """Build-time: the config compiled into static scatter plans per leaf
    (`merged`); run time: `sample(generator, n_envs) -> dict` of (E, n)
    draws, then `apply(model, samples) -> dict` of per-env leaves."""

    def __init__(self, model: Model, config: dict):
        if not isinstance(config, dict):
            raise TypeError("the randomization config is a dict "
                            "(load_config reads a YAML file)")
        default = config.get("Default", {}) or {}
        for section in ("Geoms", "Inertial"):
            if config.get(section) or default.get(section):
                raise NotImplementedError(
                    f"{section} randomization is not ported: it needs "
                    f"per-env body and geom leaves on the staged path "
                    f"(ROADMAP Queue 1 #2); only the Joints section is")
        jmap = model.names["joint"]
        exclude = set(default.get("exclude", []) or [])
        sec_joints = config.get("Joints", {}) or {}
        host = {leaf: np.asarray(getattr(model, leaf).cpu(), np.float64)
                for leaf, _ in _JOINT_FIELDS.values()}

        scatter: dict = {}  # leaf -> lists of idx, dist, p1, p2, base

        def add_scatter(leaf, flats, dist, p1, p2, base):
            if dist in (GAUSS, UNIFORM_DELTA) and np.all(p1 == 0.0):
                return  # sigma / delta 0: deterministic
            m = scatter.setdefault(
                leaf, {"idx": [], "dist": [], "p1": [], "p2": [], "base": []})
            flats = np.atleast_1d(np.asarray(flats, dtype=np.int64))
            m["idx"].append(flats)
            m["dist"].append(np.full(len(flats), dist))
            m["p1"].append(np.broadcast_to(p1, flats.shape))
            m["p2"].append(np.broadcast_to(p2, flats.shape))
            m["base"].append(np.broadcast_to(base, flats.shape))

        # Joints: a joint's own entry overrides the default; exclude
        # filters the default
        dflt_joints = default.get("Joints") or {}
        for jname, j in jmap.items():
            if jname in sec_joints:
                jconf = sec_joints[jname]
            elif dflt_joints and jname not in exclude:
                jconf = dflt_joints
            else:
                continue
            for prop, param in (jconf or {}).items():
                if prop not in _JOINT_FIELDS:
                    raise ValueError(f"joint property {prop!r} is not "
                                     f"supported for domain randomization")
                leaf, kind = _JOINT_FIELDS[prop]
                flat = int(model.jnt_dofadr[j]) if kind == "dof" else int(j)
                base = host[leaf].ravel()[flat]
                dist, p1, p2 = _dist_params(param, base, jname, prop)
                add_scatter(leaf, flat, dist, p1, p2, base)

        self.merged = {leaf: {k: np.concatenate(v) for k, v in d.items()}
                       for leaf, d in scatter.items()}
        self.n_params = sum(len(d["idx"]) for d in self.merged.values())
        self._dev = {}  # the merged tables on a device, made once

    def _tables(self, leaf: str, dtype, device) -> tuple:
        """(base, p1, p2, dist, idx) of a leaf as tensors on `device`, made
        once: a copy from host memory each draw would wait for the
        stream."""
        key = (leaf, dtype, str(device))
        hit = self._dev.get(key)
        if hit is None:
            d = self.merged[leaf]
            t = lambda x: torch.as_tensor(  # noqa: E731
                np.asarray(x), dtype=dtype, device=device)
            hit = self._dev[key] = (
                t(d["base"]), t(d["p1"]), t(d["p2"]),
                torch.as_tensor(d["dist"], device=device),
                torch.as_tensor(d["idx"], device=device))
        return hit

    def sample(self, generator: torch.Generator, n_envs: int,
               dtype=torch.float32, device=None) -> dict:
        """Each env's randomized values, {leaf: (n_envs, n)}, drawn from
        `generator` on `device` (its device by default)."""
        device = generator.device if device is None else device
        out = {}
        for leaf, d in self.merged.items():
            n = len(d["idx"])
            base, p1, p2, dist, _ = self._tables(leaf, dtype, device)
            gauss = torch.clamp(base + p1 * torch.randn(
                (n_envs, n), generator=generator, dtype=dtype, device=device),
                min=0.0)
            u = torch.rand((n_envs, n), generator=generator, dtype=dtype,
                           device=device)
            uni = p1 + u * (p2 - p1)
            uni_d = (base - p1) + u * (2.0 * p1)
            out[leaf] = torch.where(dist == GAUSS, gauss,
                                    torch.where(dist == UNIFORM, uni, uni_d))
        return out

    def apply(self, model: Model, samples: dict) -> dict:
        """Per-env copies of the randomized leaves, {leaf: (E, *shape)},
        each the model's leaf with that env's values scattered in
        (domain_randomization.py:517-531)."""
        out = {}
        for name, val in samples.items():
            leaf = getattr(model, name)
            E = val.shape[0]
            per_env = leaf.expand(E, *leaf.shape).clone()
            flat = per_env.view(E, -1)
            idx = self._tables(name, val.dtype, leaf.device)[4]
            flat[:, idx] = val.to(device=leaf.device, dtype=leaf.dtype)
            out[name] = per_env
        return out
