"""Domain randomization: per-env draws of model leaves.

Counterpart of `loco_mujoco_tpu/utils/domain_randomization.py` for the
reference YAML schema (reference `loco_mujoco/utils/domain_randomization.py
:244-514`). The config is a parsed dict (`load_config` reads a YAML file,
importing PyYAML only there):

- a `Default` section with an optional `exclude` joint list and `Joints`,
  `Geoms` and `Inertial` subsections applied to every object of that kind
  (every body but the world for the last two); an object's own entry
  *overrides* the default (the reference dispatches specific-elif-default,
  :267-294); `exclude` filters the Joints default only (:272-274);
- `Joints` properties: damping, stiffness, frictionloss, armature
  (`_JOINT_FIELDS`, set_joint_conf :299-377);
- `Geoms`, keyed by body name and applied to each geom of the body:
  friction (3 values; the contact pairs' friction is then re-mixed from
  the geoms', the element-wise max at equal priority and the higher
  priority geom's otherwise), mass and density (set_geom_conf :386-455),
  which recompute the body's mass, center, principal inertia and its frame
  from the geoms' unit-density shape constants (`Model.geom_shape`, carried
  by the committed stand-ins: the machine with the card has no MuJoCo to
  measure them, as the JAX package does by compiling a one-geom model);
- `Inertial`, keyed by body name: mass, diaginertia and fullinertia
  (set_inertial_conf :458-514); the last draws the singular values of the
  upper-triangular inertia matrix (the SVD rule, :487-501), recomposes it
  and takes its principal form (a batched `torch.linalg.eigh`, descending,
  the frame's determinant made +1, `_mat_to_quat_np_like`'s conversion);
- distributions: `sigma`, N(base, sigma) clipped to >= 0; `uniform_range`,
  U(lo, hi); `uniform_range_delta`, U(base - d, base + d), positivity
  checked at build (diaginertia and fullinertia take only this one).

`sample(generator, n_envs)` draws every env's values from an explicit
`torch.Generator`; `apply(model, samples)` turns them into per-env leaves,
{leaf: (E, *leaf shape)} (the leaves `leaves` names), each the model's leaf
(each env's own where the model's varies per env, `Model.varied`) with
that env's values in it, which the env layer carries into a per-env Model
(joint damping into `Data.dof_damping`). The eigenvectors of a 3x3 matrix
are defined up to sign: where two LAPACK builds pick other signs, the
frame `body_iquat` differs by a half turn about a principal axis, which
leaves the inertia tensor, and every stage that reads it, as it is.
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


def _quat_mat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _mat_to_quat_np_like(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (E, 3, 3) -> quaternions (E, 4) (w, x, y, z),
    branchless (Shepperd's method): the reference's `_mat_to_quat_np_like`
    per env, its case the first largest of (trace, m00, m11, m22)."""
    t = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    d = torch.diagonal(m, dim1=1, dim2=2)
    cand = torch.stack([t, d[:, 0], d[:, 1], d[:, 2]], dim=1)
    top = cand.max(dim=1, keepdim=True).values
    iota = torch.arange(4, device=m.device)
    case = torch.where(cand == top, iota, 4).min(dim=1).values

    def q_from(k):
        if k == 0:
            r = torch.sqrt(torch.clamp(1.0 + t, min=1e-12))
            return 0.5 * torch.stack([
                r, (m[:, 2, 1] - m[:, 1, 2]) / r,
                (m[:, 0, 2] - m[:, 2, 0]) / r,
                (m[:, 1, 0] - m[:, 0, 1]) / r], dim=1)
        i = k - 1
        j, l = (i + 1) % 3, (i + 2) % 3
        r = torch.sqrt(torch.clamp(
            1.0 + m[:, i, i] - m[:, j, j] - m[:, l, l], min=1e-12))
        q = [None] * 4
        q[0] = (m[:, l, j] - m[:, j, l]) / r
        q[1 + i] = r
        q[1 + j] = (m[:, j, i] + m[:, i, j]) / r
        q[1 + l] = (m[:, l, i] + m[:, i, l]) / r
        return 0.5 * torch.stack(q, dim=1)

    qs = torch.stack([q_from(k) for k in range(4)], dim=1)  # (E, 4, 4)
    q = qs[torch.arange(m.shape[0], device=m.device), case]
    return q / torch.linalg.norm(q, dim=1, keepdim=True)


def _principal(tensor: torch.Tensor):
    """(principal moments (E, 3) descending, frame quaternions (E, 4)) of
    inertia tensors (E, 3, 3), as the reference takes them: eigh, the
    order reversed, the frame's determinant made +1."""
    evals, evecs = torch.linalg.eigh(tensor)
    evals, evecs = evals.flip(-1), evecs.flip(-1)
    evecs = evecs * torch.sign(torch.linalg.det(evecs))[:, None, None]
    return evals, _mat_to_quat_np_like(evecs)


class DomainRandomizationHandler:
    """Build-time: the config compiled into static plans (`merged`: the
    scattered leaves; `fi_jobs`: the fullinertia draws; `gm_jobs`: the
    geom-mass recomputations); run time: `sample(generator, n_envs) ->
    dict` of draws, then `apply(model, samples) -> dict` of per-env
    leaves."""

    def __init__(self, model: Model, config: dict):
        if not isinstance(config, dict):
            raise TypeError("the randomization config is a dict "
                            "(load_config reads a YAML file)")
        jmap = model.names["joint"]
        bmap = model.names["body"]
        default = config.get("Default", {}) or {}
        exclude = set(default.get("exclude", []) or [])
        sec_joints = config.get("Joints", {}) or {}
        sec_geoms = config.get("Geoms", {}) or {}
        sec_inertial = config.get("Inertial", {}) or {}
        host = {n: np.asarray(getattr(model, n).cpu(), np.float64)
                for n in ("dof_damping", "jnt_stiffness", "dof_frictionloss",
                          "dof_armature", "body_mass", "body_inertia",
                          "geom_friction")}
        body_iquat = np.asarray(model.body_iquat.cpu(), np.float64)
        geom_bodyid = np.asarray(model.geom_bodyid)

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

        # Inertial: mass and diaginertia scatter; fullinertia SVD jobs
        self.fi_jobs: list = []
        dflt_inertial = default.get("Inertial") or {}
        for bname, b in bmap.items():
            if bname in sec_inertial:
                bconf = sec_inertial[bname]
            elif dflt_inertial and b != 0:
                bconf = dflt_inertial
            else:
                continue
            for prop, param in (bconf or {}).items():
                if prop == "mass":
                    base = host["body_mass"][b]
                    dist, p1, p2 = _dist_params(param, base, bname, prop)
                    add_scatter("body_mass", int(b), dist, p1, p2, base)
                elif prop in ("diaginertia", "fullinertia"):
                    if "uniform_range_delta" not in param:
                        raise ValueError(
                            "inertia randomization only supports "
                            "uniform_range_delta (reference :487-489)")
                    if prop == "diaginertia":
                        base = host["body_inertia"][b]
                        dist, p1, p2 = _dist_params(param, base, bname, prop)
                        add_scatter("body_inertia",
                                    [int(b) * 3 + k for k in range(3)],
                                    dist, p1, p2, base)
                        continue
                    # the compiled principal form back to the full tensor,
                    # then the SVD rule on its upper triangle (:493-501)
                    R = _quat_mat(body_iquat[b])
                    M = (R * host["body_inertia"][b]) @ R.T
                    triu = np.array([[M[0, 0], M[0, 1], M[0, 2]],
                                     [0.0, M[1, 1], M[1, 2]],
                                     [0.0, 0.0, M[2, 2]]])
                    U, sv, Vh = np.linalg.svd(triu)
                    delta = float(param["uniform_range_delta"])
                    if np.any(sv - delta <= 0.0):
                        raise ValueError(
                            f"fullinertia uniform_range_delta ({delta}) for "
                            f"body {bname} exceeds the smallest singular "
                            f"value ({sv.min()})")
                    self.fi_jobs.append(dict(body=int(b), U=U, Vh=Vh, s=sv,
                                             delta=delta))
                else:
                    raise ValueError(
                        f"inertial property {prop!r} is not supported")

        # Geoms: keyed by body name; friction scatters and mass jobs
        self.gm_jobs: list = []
        dflt_geoms = default.get("Geoms") or {}
        for bname, b in bmap.items():
            if bname in sec_geoms:
                gconf = sec_geoms[bname]
            elif dflt_geoms and b != 0:
                gconf = dflt_geoms
            else:
                continue
            geoms = np.nonzero(geom_bodyid == b)[0]
            if len(geoms) == 0:
                continue
            mass_dists = {}
            for prop, param in (gconf or {}).items():
                if prop == "friction":
                    for g in geoms:
                        base = host["geom_friction"][g]
                        dist, p1, p2 = _dist_params(param, base, bname, prop)
                        add_scatter("geom_friction",
                                    [int(g) * 3 + k for k in range(3)],
                                    dist, p1, p2, base)
                elif prop in ("mass", "density"):
                    mass_dists[prop] = param
                else:
                    raise ValueError(
                        f"geom property {prop!r} is not supported")
            if mass_dists:
                self.gm_jobs.append(self._geom_mass_job(
                    model, int(b), bname, geoms, mass_dists, host,
                    body_iquat))

        self.merged = {leaf: {k: np.concatenate(v) for k, v in d.items()}
                       for leaf, d in scatter.items()}
        # the pair re-mix of the geoms' friction (io._mix_pair_params's
        # rule): w1 / w2 select each geom's share
        self._pair_w = None
        if "geom_friction" in self.merged and len(model.pair_geom1):
            prio = np.zeros(model.ngeom)
            if model.geom_priority is not None:
                prio = np.asarray(model.geom_priority)
            p1 = prio[np.asarray(model.pair_geom1)]
            p2 = prio[np.asarray(model.pair_geom2)]
            self._pair_w = (np.where(p1 >= p2, 1.0, 0.0)[:, None],
                            np.where(p2 >= p1, 1.0, 0.0)[:, None])
        self.n_params = (sum(len(d["idx"]) for d in self.merged.values())
                         + 3 * len(self.fi_jobs)
                         + sum(len(j["dists"]) for j in self.gm_jobs))
        leaves = set(self.merged)
        if self.fi_jobs:
            leaves |= {"body_inertia", "body_iquat"}
        if self.gm_jobs:
            leaves |= {"body_mass", "body_ipos", "body_inertia", "body_iquat"}
        if self._pair_w is not None:
            leaves.add("pair_friction")
        self.leaves = frozenset(leaves)  # what `apply` returns
        self._dev = {}  # tables on a device, made once

    @staticmethod
    def _geom_mass_job(model, b, bname, geoms, mass_dists, host, body_iquat):
        """Constants for recomputing one body's inertial from its geoms:
        each geom's unit-density volume and unit-mass inertia (the model's
        `geom_shape`), and its center. The recombination with the base
        masses must give the compiled inertial back; where it does not, the
        body has an explicit <inertial>, which geom masses cannot change
        (the reference likewise requires the attribute in the XML)."""
        if model.geom_shape is None:
            raise ValueError(
                f"geom mass/density randomization of body {bname!r} needs "
                f"the geoms' shape constants (Model.geom_shape: "
                f"geom_shape_volume and geom_shape_inertia), which this "
                f"model does not carry")
        volume, inertia = model.geom_shape
        vols = volume[geoms]
        if np.any(~np.isfinite(vols)):
            raise ValueError(
                f"geom mass/density randomization of body {bname!r}: geoms "
                f"{geoms[~np.isfinite(vols)].tolist()} have no shape "
                f"constants (geom_shape_volume, geom_shape_inertia: "
                f"primitive geoms only; mesh-geom bodies need explicit "
                f"inertials)")
        Ks = inertia[geoms]
        centers = np.asarray(model.geom_pos.cpu(), np.float64)[geoms]
        m0 = 1000.0 * vols
        Mtot = m0.sum()
        com = (m0[:, None] * centers).sum(0) / Mtot
        inert = np.zeros((3, 3))
        for i in range(len(geoms)):
            d = centers[i] - com
            inert += m0[i] * (Ks[i] + (d @ d) * np.eye(3) - np.outer(d, d))
        R = _quat_mat(body_iquat[b])
        compiled = (R * host["body_inertia"][b]) @ R.T
        if not (np.allclose(Mtot, host["body_mass"][b], rtol=1e-4)
                and np.allclose(inert, compiled, rtol=1e-3, atol=1e-9)):
            raise ValueError(
                f"geom mass/density randomization of body {bname!r} has no "
                f"effect: the body carries an explicit <inertial> element, "
                f"which overrides geom-derived masses at compile (the "
                f"reference likewise requires the attribute in the XML)")
        dists = []
        for i in range(len(geoms)):
            if "mass" in mass_dists:
                dist, p1, p2 = _dist_params(mass_dists["mass"], m0[i], bname,
                                            "mass")
                dists.append(("mass", i, dist, float(p1[0]), float(p2[0])))
            if "density" in mass_dists:
                dist, p1, p2 = _dist_params(mass_dists["density"], 1000.0,
                                            bname, "density")
                dists.append(("density", i, dist, float(p1[0]),
                              float(p2[0])))
        return dict(body=b, m0=m0, centers=centers, Ks=Ks, vols=vols,
                    dists=dists)

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
        """Each env's randomized values, {leaf: (n_envs, n)} for the
        scattered leaves, `_fullinertia_sv` (n_envs, jobs, 3) and
        `_geom_masses` (one (n_envs, geoms) per job), drawn from
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
        if self.fi_jobs:
            t = lambda x: torch.as_tensor(  # noqa: E731
                np.asarray(x), dtype=dtype, device=device)
            s = t(np.stack([j["s"] for j in self.fi_jobs]))
            deltas = t([[j["delta"]] for j in self.fi_jobs])
            u = torch.rand((n_envs, *s.shape), generator=generator,
                           dtype=dtype, device=device)
            out["_fullinertia_sv"] = s - deltas + u * (2.0 * deltas)
        if self.gm_jobs:
            draws = []
            for job in self.gm_jobs:
                masses = torch.as_tensor(job["m0"], dtype=dtype,
                                         device=device).repeat(n_envs, 1)
                for kind, i, dist, p1, p2 in job["dists"]:
                    base = job["m0"][i] if kind == "mass" else 1000.0
                    if dist == GAUSS:
                        v = torch.clamp(base + p1 * torch.randn(
                            n_envs, generator=generator, dtype=dtype,
                            device=device), min=0.0)
                    else:
                        u = torch.rand(n_envs, generator=generator,
                                       dtype=dtype, device=device)
                        v = (p1 + u * (p2 - p1) if dist == UNIFORM
                             else (base - p1) + u * (2.0 * p1))
                    if kind == "density":
                        v = v * float(job["vols"][i])
                    masses[:, i] = v
                draws.append(masses)
            out["_geom_masses"] = draws
        return out

    def apply(self, model: Model, samples: dict) -> dict:
        """Per-env leaves, {leaf: (E, *shape)} for every leaf of `leaves`:
        each the model's (each env's own where it varies per env) with the
        draws scattered in, then the fullinertia and geom-mass bodies'
        principal forms and the pairs' friction re-mixed, in the
        reference's order (domain_randomization.py:517-608)."""
        E = next(v.shape[0] if isinstance(v, torch.Tensor) else v[0].shape[0]
                 for v in samples.values())
        out = {}

        def per_env(name):
            if name not in out:
                x = getattr(model, name)
                if name not in model.varied:
                    x = x.expand(E, *x.shape)
                out[name] = x.clone()
            return out[name]

        for name, val in samples.items():
            if name.startswith("_"):
                continue
            flat = per_env(name).view(E, -1)
            idx = self._tables(name, val.dtype, flat.device)[4]
            flat[:, idx] = val.to(device=flat.device, dtype=flat.dtype)

        if "_fullinertia_sv" in samples:
            inertia, iquat = per_env("body_inertia"), per_env("body_iquat")
            for n, job in enumerate(self.fi_jobs):
                sv = samples["_fullinertia_sv"][:, n].to(inertia.dtype)
                U = torch.as_tensor(job["U"], dtype=sv.dtype,
                                    device=sv.device)
                Vh = torch.as_tensor(job["Vh"], dtype=sv.dtype,
                                     device=sv.device)
                triu = U @ torch.diag_embed(sv) @ Vh  # (E, 3, 3)
                # the reference keeps the upper triangle as the tensor
                full = torch.triu(triu) + torch.triu(triu, 1).transpose(1, 2)
                evals, q = _principal(full)
                inertia[:, job["body"]] = evals
                iquat[:, job["body"]] = q

        if "_geom_masses" in samples:
            mass_l, ipos_l = per_env("body_mass"), per_env("body_ipos")
            inertia, iquat = per_env("body_inertia"), per_env("body_iquat")
            for job, masses in zip(self.gm_jobs, samples["_geom_masses"]):
                masses = masses.to(mass_l.dtype)
                t = lambda x: torch.as_tensor(  # noqa: E731
                    x, dtype=masses.dtype, device=masses.device)
                centers, Ks = t(job["centers"]), t(job["Ks"])
                Mtot = masses.sum(1)
                com = (masses[..., None] * centers).sum(1) / torch.clamp(
                    Mtot, min=1e-12)[:, None]
                d = centers - com[:, None]  # (E, G, 3)
                dd = torch.sum(d * d, dim=2)
                eye = torch.eye(3, dtype=masses.dtype, device=masses.device)
                inert = (torch.einsum("eg,gij->eij", masses, Ks)
                         + torch.einsum("eg,ij,eg->eij", masses, eye, dd)
                         - torch.einsum("eg,egi,egj->eij", masses, d, d))
                evals, q = _principal(inert)
                b = job["body"]
                mass_l[:, b] = Mtot
                ipos_l[:, b] = com
                inertia[:, b] = evals
                iquat[:, b] = q

        if self._pair_w is not None:
            gf = per_env("geom_friction")
            w1, w2 = (torch.as_tensor(w, dtype=gf.dtype, device=gf.device)
                      for w in self._pair_w)
            f1 = gf[:, np.asarray(model.pair_geom1)] * w1
            f2 = gf[:, np.asarray(model.pair_geom2)] * w2
            fri = torch.maximum(f1, f2)
            out["pair_friction"] = torch.stack(
                [fri[..., 0], fri[..., 0], fri[..., 1], fri[..., 2],
                 fri[..., 2]], dim=-1)
        return out
