#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root: `python3 chip_smoke.py`. It

1. prints the card and its power limit (nvidia-smi);
2. builds the Hopper kernels from `loco_mujoco_tpu_torch/csrc/*.cu` and
   prints what ptxas reports of each (registers, stack, spills), and, for
   the mega kernels (a warp per env, its state in shared memory), each
   main-path configuration's launch: shared bytes per env, envs per block
   and the resident warps per SM that
   `cudaOccupancyMaxActiveBlocksPerMultiprocessor` gives both kernels (at
   least 4); and the same for the fused kernel (every configuration with a
   plan, with and without the damping rows) and the standalone Newton
   kernel (the two configurations without a plan), which run a warp per
   env on the mega kernels' warp core (`csrc/warp_core.cuh`), and the
   plane-mesh kernel (`csrc/plane_mesh.cu`, a warp per env) on six
   kernel-gated groups;
3. loads the committed HumanoidTorque-shaped model (nv = 19, 75 plane-mesh
   pairs) in five configurations, each a change of the loaded arrays: RK4
   and Euler with uniform contact statics (the mega plan), per-pair
   friction (the fused kernel's 7-float contact pack), one pair's solref
   (the generic 26-float pack), and 34 mesh slots per group (456 rows,
   past the fused kernel's 400: no plan, the standalone Newton kernel);
   the committed HumanoidMuscle-shaped model (the same tree and hulls,
   92 site-path tendons driving 92 muscles, Euler: the `muscle`
   configuration, a non-smooth plan with the mega path's muscle block);
   the committed UnitreeA1-shaped model (nv = 18, elliptic cones at
   impratio 100, 76 slots over every classic analytic pair kind, 300 rows,
   Euler: the `a1` configuration, the mega path's extended collision
   `mega_ell` and the fused kernel's elliptic layout); and the committed
   UnitreeH1- and Atlas-shaped bipeds (the `h1` configuration: nv = 17,
   Euler, a plane-cylinder group with its pairs in order beside a
   plane-mesh group, 40 slots, 176 rows; `atlas`: nv = 19, RK4, top-K
   plane-cylinder and plane-box groups, 64 slots, 272 rows), pyramidal
   models on the mega path's plane-only collision with its cylinder
   branch; and the committed UnitreeG1-shaped biped (the `g1`
   configuration: nv = 19, Euler, pyramidal cones, 68 slots over 8 foot
   points, 2 toe rollers, 18 plane-mesh hulls and three self groups
   between the legs, 288 rows: the mega path's extended collision with
   pyramidal rows and a plane-mesh group); and the committed A1 position
   stand-in (the `a1pos` configuration: A1's tree, contacts and rows with
   a position servo per leg joint, fixed gain and affine bias, the ctrl a
   target angle: the smooth stage's affine terms in the mega kernels'
   extended elliptic instance and in the fused kernel); and the committed
   stand-in of G1 with its arms (the `g1arms` configuration: nv = 29,
   past the first compiled width, 25 bodies, 72 slots, 312 rows: the
   libraries built a second time at width 32, the mega kernels' extended
   pyramidal instance with the rows' J in a global scratch), and with 20
   plane-mesh slots (455 rows: no plan, the Newton kernel at width 32);
   and the committed stand-ins of H1 and Atlas with their arms (the
   `h1arms` configuration: nv = 25, Euler, 40 slots, 184 rows, J in shared
   memory; `atlasarms`: nv = 31, RK4, 64 slots, 288 rows, J in the global
   scratch: the wide library's plane-only instance); and the committed
   stand-ins whose plane-mesh group is at k = P, which the mega kernels
   rank, deepest first, where the staged path keeps its pairs in order
   (`KP`: `talos`, the Talos-shaped biped, nv = 18, Euler, a plane-box
   group and 8 hulls at k 8, 32 slots, 144 rows, the plane-only instance;
   `g1kp`, the small G1 at plane budget 10, nv = 15, 10 hulls at k 10, 44
   slots, 192 rows, the extended pyramidal instance);
4. holds each kernel of the earlier staged path against its plain PyTorch
   version on the card, on the inputs that path gives it at full width
   (4096 envs);
5. drives the staged path (`LMT_MEGA=0`) for 1 control step of 10 RK4
   substeps, 1 of 10 Euler substeps, 1 of 10 muscle Euler substeps (the
   fused kernel's non-smooth layout), 1 of 10 A1 Euler substeps (torch
   collision and the fused kernel's elliptic layout) and 1 each of H1,
   Atlas and G1 (its plane-mesh group on the plane-mesh kernel, its
   other groups in torch, the fused kernel's 26-float pack) and 1 of
   A1's position mode (the elliptic layout with affine bias), through
   the fused constraint kernel (each cut from 2 to keep the run short),
   1 of G1 with its arms (the fused kernel at width 32), 1 each of H1 and
   Atlas with their arms (the fused kernel at width 32), 1 of Talos (its
   plane-mesh group at k = P in torch, in pair order, and the fused
   kernel), and 1 control step of the
   model with no plan, through the Newton kernel (a warp per env on the
   solve's env-major operands: no relayout around it), and
   1 of G1 with its arms with no plan (the Newton kernel at width 32), with
   every launch counter set to 0 just before each run and read just after,
   and checks the counts; then compares one staged forward with the
   all-plain forward and holds the Newton kernel to its plain version at
   the no-plan run's end state;
6. drives the main path, as `bench.py` does: one forward at reset (the
   mega forward kernel) and `forward.step_n` for 20 control steps of 10
   substeps (one megastep kernel launch each), RK4, Euler, the muscle
   model (seeded muscle ctrls in [0, 1], act from 0), A1 (dropped 5-20
   mm, seeded motor ctrls in half its ctrlrange), H1, Atlas, G1, G1
   with its arms, H1 with its arms, Atlas with its arms, Talos and G1 at
   k = P
   (dropped 5-20 mm, seeded motor ctrls in [-0.3, 0.3]) and A1's position
   mode (dropped 5-20 mm, seeded targets uniform in the joint ranges),
   counters again
   zeroed
   just before and read just after, and checks the state, the contacts,
   the activations within [0, 1] and that exactly these launches were made;
   then drives the env layer (`LocoEnv`, `envs.standins.make_env`): the RK4
   humanoid's
   env at 4096 envs (random starts on a synthetic trajectory, the
   target-velocity reward, its fall predicate), 20 `step_batch` calls with
   seeded actions in episodes of 8 control steps (the auto-reset merge
   runs), then in one episode without and with joint-damping
   randomization (the damping rows' plan variant), each beside
   `forward.step_n` alone on the same state and controls, the megastep
   with and without the rows in turns, and A1's env with the
   randomization (Euler: the per-substep mega forward with the rows), and
   both randomized envs on the staged path (the fused kernel's smooth and
   elliptic layouts with the rows), then G1's env (its own fall
   predicate) without randomization beside `step_n` alone and with it
   (Euler: the per-substep mega forward with the rows), A1's position
   mode's env (actions unnormalized into the joint ranges), the env of
   G1 with its arms beside `step_n` alone and with damping randomization
   (Euler: the wide per-substep mega forward with the rows), the envs of H1
   with its arms beside `step_n` alone and of Atlas with its arms with
   damping randomization (RK4: the wide megastep with the rows) beside
   `step_n` alone, and Talos's env (its own fall predicate) beside
   `step_n` alone, counters zeroed and read as above; each pairing of
   `step_batch` with `step_n` alone runs PAIRINGS (3) times in turns, and
   the medians and spreads are printed;
7. holds the mega forward kernel and the megastep kernel (one control
   step), RK4, Euler, muscle (with act_dot and act; the muscle kernels
   both at the end state, which the seeded activations lift off the
   floor, and after the first control step, in deep contact), A1 (the
   extended collision's geom1 and geom2 too), H1, Atlas and G1 (their end
   states in contact; G1's the extended pyramidal instance, with and
   without the damping rows), A1's position mode (the servos' affine
   bias; at its env's end state, where A1's fall predicate has reset the
   tipped trunks), G1 with its arms (the wide library's extended
   pyramidal instance), H1 and Atlas with their arms (the wide library's
   plane-only instance, J in shared memory and in the global scratch),
   the damping rows at width 32 (the mega forward's plane-only and
   extended pyramidal instances and the RK4 megastep, at the randomized
   arms envs' end states), Talos and G1 at k = P (their plane-mesh groups
   ranked: the plane-only and extended pyramidal instances), the
   plane-mesh kernel (`mesh_slots`, select and top-K in one launch) on the
   torque model's, G1's and `wide`'s (k 34) mesh groups, every pair's key
   besides the slots, and the fused kernel on all four
   plan
   configurations, the muscle model's non-smooth layout, A1's elliptic
   layout, H1, Atlas, G1, A1's position mode, G1, H1 and Atlas with their
   arms (width 32; with the damping rows at the randomized arms envs' end
   states), Talos, the Newton kernel at width 32 at the end state of the no-plan
   G1 with arms, and the damping rows
   (the mega forward's
   plane-only and extended instances, the RK4 megastep, the fused
   kernel's smooth and elliptic layouts, at the randomized envs' end
   states), to their plain versions replaying the kernels'
   Newton decisions (the iteration count, the taken steps, the line
   search's signs and each step's Hessian decision of every row), on all
   4096 envs; a mega check (and the elliptic fused check) excuses at most
   0.5% of the envs, each only as a float32 tie (a slot or limit within
   TIE of its margin), as a Newton disagreement at a shared state that a
   float64 witness settles for the kernel, or (the megastep) as a
   trajectory parted by the replay itself, where the kernel is shown
   right without it, or on a plane-mesh support-vertex tie at a shared
   state (_megastep_rule); and the replayed row decisions
   may depart from the plain version's own at the first Newton step (the
   shared start) in at most 0.5% of the envs (_row_departures);
   Then two phases of model leaves that differ per env, at 4096 envs:
   `variants`, the torque humanoid at the four 4-ages scalings as stacked
   model variants (`envs.standins.load_variants("humanoid4ages")`, env_id
   drawn at reset, 3 `step_batch` calls: no row plan, so the staged path
   with the Newton kernel and the plane-mesh kernel reading each env's
   variant's hull table of four), the plane-mesh kernel with its four
   tables (`_mesh_slots_rule`) and the Newton kernel (`newton_check`)
   held to their plain versions at the end state; and `dr_leaves`, the
   torque humanoid's env with each env's masses, the torso's full inertia
   (the SVD rule), armature and the knees' stiffness randomized (2
   `step_batch` calls through the fused kernel's non-smooth layout, held
   to its plain version on every env at the end state), then with the
   knees' friction loss randomized (no row plan: 1 call through the
   Newton kernel, held); launches counted per run, rates printed;
8. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, beside the least time the card
   could take (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
   the H100 SXM data-sheet peaks at 700 W); the plane-mesh kernel also
   by its launch alone, at the staged RK4, G1 and no-plan runs' end
   states; the layout kernel per call site (one launch for all of a
   site's arrays in a forward: the plane-mesh group's four operands and
   four results, which the one-thread select and top-K relayed and the
   plane-mesh kernel reads and writes env-major; the Newton solve's
   operands and two results, which the one-thread solve relayed and the
   warp solve reads as they are, so no path launches a relayout now)
   also by its launch alone (the launcher on
   outputs made beforehand: the row's time brackets the wrapper's checks,
   allocation and ctypes dispatch), and the wrapper's host time split by
   part (`tools/layout_host.py`: 1000 calls at 128 envs);
9. prints one JSON line of kernels and, last, one JSON line with `"ok"`.

It exits non-zero, printing no result, when no CUDA device is present or
the port is missing. Every float32 matmul and convolution runs in full
float32: TF32 is switched off, as the JAX package scopes its physics to
exact float32 (`_exact_f32`, loco_mujoco_tpu/ops/forward.py) because the
constraint Hessian can go indefinite at lower precision.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

N_ENVS = 4096
CONTROL_STEPS = 20  # the main path
STAGED_STEPS = 1  # the staged path, cut from 20 to keep the run short
WIDE_STEPS = 1  # the no-plan staged paths (the Newton kernel's) and G1 arms' staged path
VARIANT_STEPS = 3  # the variants phase's step_batch calls (staged, no plan)
DR_STEPS = 2  # the dr_leaves phase's env with per-env masses (fused kernel)
FLOSS_STEPS = 1  # and with per-env friction loss (no plan: Newton kernel)
SUBSTEPS = 10  # physics substeps per control step (RK4: 4 forwards each)
TIE = 1e-5  # a slot or limit this close to its margin is a float32 tie
# a slot whose point moved farther (m) between two forwards of one state
# holds another contact (float32 rounding moves it ~1e-7)
SLOT_MOVED = 1e-5
SHOW_ENVS = 10  # envs printed per check
WITNESS_ITERATIONS = 30  # Newton and line-search steps of the float64 witness
# the reference's own tolerance on float32 elliptic solves
# (tests/test_pallas_newton.py:152-159, the fused elliptic forces): the
# farthest an elliptic solve cut at its Newton budget may lie from the
# float64 replay of its own decisions (_newton_witness)
ELL_TOL = 2e-3
SEED = 0
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BIG = 1e10
# configurations of the committed model: a static entry, or the first
# column of the last contact pair's row of a leaf
CONFIGS = {
    "rk4": {},
    "euler": {"opt.integrator": 0},
    "fric": {"leaf:pair_friction": 0.8},
    "solref": {"leaf:pair_solref": 0.03},
    "wide": {"contact_k_plane": 34},
}
MUSCLE_ASSET = "loco_mujoco_tpu_torch/assets/humanoid_muscle_shape.npz"
A1_ASSET = "loco_mujoco_tpu_torch/assets/unitree_a1_shape.npz"
# the bipeds with plane-cylinder groups: configuration -> (asset, seed of
# their draws' own stream)
BIPEDS = {"h1": ("loco_mujoco_tpu_torch/assets/unitree_h1_shape.npz", 2),
          "atlas": ("loco_mujoco_tpu_torch/assets/atlas_shape.npz", 3)}
# the G1-shaped biped on the extended collision with pyramidal rows and a
# plane-mesh group: (asset, seed of its draws' own stream)
G1 = ("loco_mujoco_tpu_torch/assets/unitree_g1_shape.npz", 4)
# G1 with its arms (nv 29: the kernels' second compiled width, 32), its
# draws' own stream; with 20 plane-mesh slots it has no plan (455 rows) and
# its staged path runs the Newton kernel at width 32
G1ARMS = ("loco_mujoco_tpu_torch/assets/unitree_g1_arms_shape.npz", 6)
G1ARMS_WIDE = {"contact_k_plane": 20}
# H1 and Atlas with their arms (nv 25 and 31: the wide library's plane-only
# instance, H1's J in shared memory, Atlas's in the global scratch): the
# committed stand-ins of `envs.standins.STANDINS`, their draws' own streams
ARMS = {"h1arms": 12, "atlasarms": 13}
# the stand-ins with a plane-mesh group at k = P, which the mega kernels rank
# (`envs.standins.STANDINS`), their draws' own streams: Talos (nv 18, the
# plane-only instance beside a plane-box group) and the small G1 at plane
# budget 10 (nv 15, the extended pyramidal instance)
KP = {"talos": 14, "g1kp": 15}
# runs of each env-phase pairing of step_batch and step_n alone, in turns
PAIRINGS = 3
# A1's seeded motor ctrls lie in [-A1_CTRL, A1_CTRL] of its ctrlrange
# [-1, 1] (17 of the motors' 34 N m): with the full range redrawn every
# control step some envs spin their light, slender calves fast enough that
# Euler at 2 ms diverges, in the JAX package's float64 path as in the port
A1_CTRL = 0.5
# A1's position mode (`a1pos`): the committed stand-in of
# `envs.standins.STANDINS`, its draws' own stream; its servos' targets lie
# uniform in the joint ranges (the JAX package's float64 path stays bounded
# there under Euler at 2 ms over this depth)
A1POS_SEED = 5


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps=10, warmup=True):
    """Mean CUDA-event time of `fn()` over `reps` runs after a warm-up (a
    plain version, no yardstick and already run by its check, is timed
    once without one: `warmup` False)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tool(name):
    """tools/<name>.py of this checkout, as a module."""
    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _active_close(got, ref, active, atol, what):
    err = float((got - ref).abs()[active].max()) if bool(active.any()) else 0.0
    if not err <= atol:
        raise AssertionError(f"{what}: max abs error {err} > {atol}")
    return err


def _mesh_slots_rule(torch, plan, gxp, gxm, what, env_id=None):
    """The plane-mesh kernel (`hopper_collision.mesh_slots`, one launch)
    against its plain version on every env of the geom poses gxp, gxm
    (and, for a plan of K > 1 variants' hull tables, each env's variant
    env_id):
    the active slots and the ranks' geom ids and statics exact, depths
    within 1e-6, positions 1e-5, frames 1e-6, and the ranking key of every
    near pair (its extent bound reaches the margin, so the kernel walks
    its vertices) within 1e-6; a far pair's key lies at or past 0 in both
    (the kernel's is the bound's). Returns (max abs error, active slots,
    near pairs)."""
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc
    from loco_mujoco_tpu_torch.ops import kernels

    E, P = gxp.shape[0], plan.P
    k_key = torch.empty(E, P, device=gxp.device)
    p_key = torch.empty_like(k_key)
    kernels.LAUNCHES.clear()
    got = hc.mesh_slots(plan, gxp, gxm, k_key, env_id=env_id)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"mesh_slots": 1}, kernels.LAUNCHES
    kernels.LAUNCHES.clear()
    ref = hc.mesh_slots_plain(plan, gxp, gxm, p_key, env_id=env_id)
    on = ref[0] < BIG / 2  # (E, k, 3) active slots
    assert torch.equal(got[0] < BIG / 2, on), f"{what}: active slots differ"
    rank = on[..., 0]  # the ranks whose pair's key is below 0
    for i in range(3, 9):
        assert torch.equal(got[i][rank], ref[i][rank]), \
            f"{what}: geom ids or statics differ"
    t = plan.tensors(gxp.device)
    pf = hc.variant_tables(plan, t, env_id)[1]
    a, b = hc.plane_in_mesh_frame(gxp, gxm, t.pg1, t.pg2)
    near = hc.extent_bound(pf, a, b) < pf[..., 0]
    assert bool((k_key[~near] >= 0).all()) and bool(
        (p_key[~near] >= 0).all()), f"{what}: a far pair's key below 0"
    err = max(
        _active_close(got[0], ref[0], on, 1e-6, f"{what} dist"),
        _active_close(got[1], ref[1], on[..., None].expand(-1, -1, -1, 3),
                      1e-5, f"{what} pos"),
        _active_close(got[2], ref[2], rank[..., None, None].expand(
            -1, -1, 3, 3), 1e-6, f"{what} frame"),
        _active_close(k_key, p_key, near, 1e-6, f"{what} key"))
    return err, int(on.sum()), int(near.sum())


@contextlib.contextmanager
def _staged_path():
    """The staged path: the mega path off (`LMT_MEGA=0`)."""
    old = os.environ.get("LMT_MEGA")
    os.environ["LMT_MEGA"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LMT_MEGA"]
        else:
            os.environ["LMT_MEGA"] = old


def _margin_gap(m, d):
    """Per env, the smallest |dist - margin| over the contact slots and the
    joint limits: the rows whose activation is a threshold test."""
    gap = (d.contact.dist - d.contact.includemargin).abs().min(dim=1).values
    for r in m.plan.lim:
        x = d.qpos[:, r["q"]]
        dist = (x - r["lo"]).minimum(r["hi"] - x)
        gap = gap.minimum((dist - r["margin"]).abs())
    return gap


def _newton_witness(torch, m, S, k, p, envs=None, staged=False):
    """Per env, at one state S that the kernel's and the plain version's
    forwards share (`k`, `p`, the kernel's decisions replayed):
    (apart, witnessed). `apart`: their accelerations lie more than rel
    5e-4 (of the plain version's largest) apart (among `envs`, a mask,
    where given); with elliptic cones also their constraint or contact
    forces (impratio 100 makes the friction rows 100 times stiffer than
    the normal's, so the forces move more than qacc). The replay covers
    the iteration count, the taken steps, the line search's sign tests and
    the rows' Hessian decisions, not the line search's own row tests at
    its trial points. `witnessed`: the float64
    witness (tools/newton_witness.py) settles such an env for the kernel:
    the state's Newton problem (the plain version's rows) solved in float64
    to convergence lies within rel 5e-4 of the kernel's acceleration (and,
    elliptic, its constraint forces), and no farther from it than the
    plain version's. With elliptic cones the witness is also the same
    solve in float64 replaying the kernel's decisions from the same start
    (the kernel's computation in exact arithmetic): it settles an env that
    lies no farther from the kernel than from the plain version, and
    within rel 5e-4 of the kernel, or within ELL_TOL where the kernel ran
    its whole Newton budget (a solve cut mid-way, which float32 does not
    fix to 5e-4: the plain version lies as far).

    `staged`: S already holds the stages' outputs (the fused kernel's
    inputs). Prints each apart env's reading."""
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn

    ell_model = m.plan.elliptic
    scale = float(p.qacc.abs().max())
    fscale = float(p.qfrc_constraint.abs().max()) + 1e-9
    E = k.qacc.shape[0]
    apart = (k.qacc - p.qacc).abs().amax(1) > 5e-4 * scale
    if ell_model:
        cscale = float(p.efc_force_contact.abs().max()) + 1e-9
        apart |= (((k.qfrc_constraint - p.qfrc_constraint).abs().amax(1)
                   > 5e-4 * fscale)
                  | ((k.efc_force_contact - p.efc_force_contact).abs()
                     .reshape(E, -1).amax(1) > 5e-4 * cscale))
    if envs is not None:
        apart &= envs
    witnessed = torch.zeros_like(apart)
    idx = apart.nonzero().flatten()
    if not len(idx):
        return apart, witnessed
    plan = m.plan
    _, problem, ell = hf.newton_problem(
        m, S if staged else hm.plain_stages(m, S))
    if ell is not None:  # these envs' cone coefficients, in float64
        ell = (ell[0], ell[1].double(), ell[2][idx].double(), ell[3])
    sub = [t[idx].double() for t in problem]
    opt = dict(ne=plan.ne, nfl=plan.nfl, scale=plan.scale, ell=ell)
    x_c, f_c = hn.newton_plain(
        *sub, k.qacc[idx].double(), iterations=WITNESS_ITERATIONS,
        ls_iterations=WITNESS_ITERATIONS, tol=1e-14, **opt)[:2]

    def err(d, x_w, f_w):
        e = (d.qacc[idx].double() - x_w).abs().amax(1) / scale
        if not ell_model:
            return e
        q_w = torch.einsum("erv,er->ev", sub[0] * sub[6][..., None], f_w)
        return torch.maximum(e, (d.qfrc_constraint[idx].double() - q_w)
                             .abs().amax(1) / fscale)

    e_k, e_p = err(k, x_c, f_c), err(p, x_c, f_c)
    ok = (e_k <= 5e-4) & (e_k <= e_p)
    reading = [f"against the converged float64 witness: kernel rel "
               f"{float(a):.3g}, plain rel {float(b):.3g}"
               for a, b in zip(e_k, e_p)]
    if ell_model:
        x_r, f_r = hn.newton_plain(
            *sub, S.qacc_warmstart[idx].double(), iterations=plan.iterations,
            ls_iterations=plan.ls_iterations, tol=plan.tolerance,
            replay=(k.solver_niter[idx], k.solver_taken[idx],
                    k.solver_ls[idx], k.solver_rows[idx]), **opt)[:2]
        r_k, r_p = err(k, x_r, f_r), err(p, x_r, f_r)
        full = k.solver_niter[idx] >= plan.iterations
        ok |= (r_k <= r_p) & (r_k <= torch.where(full, ELL_TOL, 5e-4))
        reading = [f"{t}; against the float64 replay: kernel rel "
                   f"{float(a):.3g}, plain rel {float(b):.3g}"
                   for t, a, b in zip(reading, r_k, r_p)]
    witnessed[idx] = ok
    e_qs = ((k.qacc_smooth[idx] - p.qacc_smooth[idx]).abs().amax(1)
            / float(p.qacc_smooth.abs().max()))
    for e, es, t, w in zip(idx.tolist(), e_qs.tolist(), reading,
                           ok.tolist()):
        print(f"  env {e}: apart at a shared state (their qacc_smooth rel "
              f"{es:.3g}, {int(k.solver_niter[e])} Newton steps); {t} "
              f"({'the kernel holds' if w else 'not settled'})")
    return apart, witnessed


def _row_departures(torch, k, own, E, what):
    """The rows whose Hessian decision the kernel recorded (and the plain
    version replayed) where the plain version's own test at the same
    step's x decides otherwise (`own`, newton_plain's `own_rows`). At the
    first Newton step both start from the same x, so such rows are float32
    ties and may lie in at most 0.5% of the envs; over the later steps they
    are counted. Prints both counts; returns the first step's envs."""
    diff = k.solver_rows ^ own
    n = sum(((diff >> b) & 1) for b in range(32)).sum(-1)  # (E, steps)
    e0 = int((n[:, 0] > 0).sum())
    print(f"  {what}: replayed row decisions the plain version's own tests "
          f"do not make: {int(n[:, 0].sum())} rows in {e0} envs at the "
          f"first Newton step, {int(n.sum())} rows in "
          f"{int((n.sum(1) > 0).sum())} envs over all steps")
    if e0 > 0.005 * E:
        raise AssertionError(f"{what}: {e0} envs depart from the plain "
                             f"version's own row decisions at the first "
                             f"Newton step, more than 0.5%")
    return e0


def _tie_envs(torch, held, gap, E, what, err=None, newton=None,
              replay=None, vertex=None):
    """Envs where the comparison does not hold are excluded only as float32
    ties: where a contact slot or a joint limit lies within TIE of its
    margin, or (`newton`) where every disagreement of the two versions at
    a state they shared was settled for the kernel by the float64 witness
    (_newton_witness), or (`replay`, the megastep) where the trajectories
    part by the replay itself (_megastep_rule), or (`vertex`, the
    megastep) where the two versions part at a shared state on a
    plane-mesh support-vertex tie there (_vertex_ties); and only up to
    0.5% of the envs, all four kinds counted together.
    Returns their count; prints each excluded env (`err`: its relative
    error)."""
    out = ~held
    n = int(out.sum())
    tie = gap < TIE
    for extra in (newton, replay, vertex):
        if extra is not None:
            tie = tie | extra
    for e in torch.nonzero(out).flatten().tolist()[:SHOW_ENVS]:
        print(f"  {what}: env {e} differs"
              + ("" if err is None else f" (rel {float(err[e]):.3g})")
              + f", nearest margin {float(gap[e]):.3g}"
              + ("" if newton is None else
                 f", Newton disagreement settled by the witness: "
                 f"{bool(newton[e])}")
              + ("" if replay is None else
                 f", parted by the replay: {bool(replay[e])}")
              + ("" if vertex is None else
                 f", parted on a support-vertex tie: {bool(vertex[e])}"))
    if n > SHOW_ENVS:
        print(f"  {what}: {n - SHOW_ENVS} more envs differ")
    if n and not bool(tie[out].all()):
        raise AssertionError(f"{what}: {int((out & ~tie).sum())} envs "
                             f"differ with no tie")
    if n > 0.005 * E:
        raise AssertionError(f"{what}: {n} tie envs, more than 0.5%")
    return n


def _ulp(torch, x):
    """The float32 ulp at |x| (float64)."""
    x = x.abs().float()
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).double()


def _moved(torch, fk, fp, lo, hi):
    """(E, hi - lo) per slot of a group, active in either forward: its
    geom or its point differs (past SLOT_MOVED) between the two (`fk`
    made with `points=True`)."""
    ck, cp = fk.contact, fp.contact
    on = (ck.dist < ck.includemargin) | (cp.dist < cp.includemargin)
    diff = ((ck.geom2 != cp.geom2)
            | ((ck.pos - cp.pos).abs().amax(-1) > SLOT_MOVED))
    return (on & diff)[:, lo:hi]


def _vertex_ties(torch, m, d, fk, fp, envs):
    """Among `envs` (a mask): a plane-mesh pair whose slot differs between
    the kernel's forward `fk` and the plain version's `fp` at the shared
    state `d` (in geom or point, _moved) has a second hull vertex within 2
    float32 ulps of its support depth, the ulp taken at the magnitude of
    the depth's largest term (the mesh origin's height above the plane, b
    in a.v + b). Which of two such vertices is the support is decided by
    float32 rounding (of the FK, of a.v + b), and it moves the pair's
    manifold by the vertices' distance (tests/test_torch_cuda.py's H1
    env 810: 1.9e-9 apart at b ~ 0.1 m, 5.7 mm apart in x, y). Prints
    each env's pair."""
    import numpy as np

    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc
    from loco_mujoco_tpu_torch.ops import kinematics

    E, dev = d.qpos.shape[0], d.qpos.device
    tie = torch.zeros(E, dtype=torch.bool, device=dev)
    pos = kinematics.kinematics(m, d)
    for g in m.groups:
        if not coll.is_plane_mesh(g):
            continue
        pid = np.asarray(g.pair_ids)
        pg1, pg2 = m.pair_geom1[pid], m.pair_geom2[pid]
        a, b = hc.plane_in_mesh_frame(pos.geom_xpos, pos.geom_xmat, pg1,
                                      pg2)  # (E, P, 3), (E, P)
        mesh = np.maximum(np.asarray(m.geom_meshid)[pg2], 0)
        verts = m.mesh_vert[mesh].double()  # (P, V, 3)
        valid = torch.as_tensor(np.asarray(m.mesh_vertmask)[mesh],
                                device=dev)
        h = torch.einsum("epj,pvj->epv", a.double(), verts) \
            + b.double()[..., None]
        h = torch.where(valid, h, torch.full_like(h, float("inf")))
        d0 = h.min(dim=-1).values
        close = ((h - d0[..., None]) <= 2 * _ulp(torch, b)[..., None]
                 ).sum(-1) >= 2
        # the pairs (by their mesh geom) in this group's slots that differ
        lo, hi = g.offset, g.offset + g.k * g.slots
        moved = _moved(torch, fk, fp, lo, hi)
        pg2_t = torch.as_tensor(np.asarray(pg2), device=dev)
        in_moved = torch.zeros_like(close)
        for f in (fk, fp):
            in_moved |= ((f.contact.geom2[:, lo:hi, None] == pg2_t)
                         & moved[..., None]).any(1)
        hit = close & envs[:, None]
        tie |= (hit & in_moved).any(1)
        for e, q in hit.nonzero().tolist()[:SHOW_ENVS]:
            print(f"  env {e}: support-vertex tie of pair {int(pid[q])} "
                  f"(geoms {int(pg1[q])}, {int(pg2[q])}), its slots "
                  + ("differ" if bool(in_moved[e, q]) else "the same")
                  + " in the two forwards")
    return tie


def _rank_ties(torch, m, d, fk, fp, envs):
    """Among `envs` (a mask): at the state `d` the kernel's forward `fk`
    and the plain version's `fp` (replaying fk's decisions) fill a top-K
    group with the same pairs but rank some in another order, and the
    plain version with its slots put in the kernel's order, replaying the
    same decisions, agrees with the kernel (qacc within rel 5e-4 of the
    plain version's largest). Which of two pairs whose ranking keys nearly
    tie ranks first is decided by float32 rounding; it swaps their slots,
    and a replay of the kernel's decisions then lands on other rows
    (tests/test_torch_cuda.py's step_batch env 107: two foot meshes'
    support depths 4.5e-9 apart). A pair that only one of them selects is
    no such tie. Prints each env's ranks with both versions' depths."""
    import dataclasses

    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm

    E, dev = d.qpos.shape[0], d.qpos.device
    perm = torch.arange(m.ncon, device=dev).expand(E, -1).clone()
    swapped = torch.zeros(E, dtype=torch.bool, device=dev)
    other = torch.zeros_like(swapped)
    for g in m.groups:
        # the ranked groups: top-K ones, and a plane-mesh group at k = P,
        # which the mega kernels rank too
        if g.convex or (g.k >= len(g.pair_ids) and not coll.is_plane_mesh(g)):
            continue
        first = g.offset + g.slots * torch.arange(g.k, device=dev)
        ids = [f.contact.geom1[:, first] * m.ngeom + f.contact.geom2[:, first]
               for f in (fk, fp)]  # (E, k) the pair at each rank
        diff = ids[0] != ids[1]
        for e in (envs & diff.any(1)).nonzero().flatten().tolist():
            ranks = diff[e].nonzero().flatten().tolist()
            k_ids, p_ids = ids[0][e].tolist(), ids[1][e].tolist()
            src = {}  # the kernel's rank -> the plain version's
            for r in ranks:
                hit = [q for q in ranks if p_ids[q] == k_ids[r]
                       and q not in src.values()]
                if not hit:
                    other[e] = True
                    break
                src[r] = hit[0]
            swapped[e] = True
            for r, q in src.items():
                for j in range(g.slots):
                    perm[e, g.offset + r * g.slots + j] = (
                        g.offset + q * g.slots + j)
                print(f"  env {e}: top-K rank {r} of group ({g.t1}, {g.t2}) "
                      f"holds geom {k_ids[r] % m.ngeom} in the kernel "
                      f"(depth {float(fk.contact.dist[e, first[r]]):.9g}), "
                      f"geom {p_ids[r] % m.ngeom} in the plain version "
                      f"({float(fp.contact.dist[e, first[r]]):.9g})")
    swapped &= ~other
    if not bool(swapped.any()):
        return swapped
    st = hm.plain_stages(m, d)
    c = st.contact

    def take(t):
        idx = perm.reshape(E, -1, *([1] * (t.dim() - 2))).expand_as(t)
        return t.gather(1, idx)

    c = c.replace(**{f.name: take(getattr(c, f.name))
                     for f in dataclasses.fields(c)
                     if isinstance(getattr(c, f.name), torch.Tensor)})
    r = hf.fused_constraint_plain(
        m, st.replace(contact=c), (fk.solver_niter, fk.solver_taken,
                                   fk.solver_ls, fk.solver_rows),
        solve64=hm.ext_mode(m.plan) == 1)
    rel = (fk.qacc - r.qacc).abs().amax(1) / float(fp.qacc.abs().max())
    for e in swapped.nonzero().flatten().tolist()[:SHOW_ENVS]:
        print(f"  env {e}: the plain version in the kernel's slot order "
              f"replaying its decisions: qacc rel {float(rel[e]):.3g} from "
              f"the kernel's")
    return swapped & (rel <= 5e-4)


def _megastep_rule(torch, m, S1, n, what, on_forward=None):
    """n substeps of the megastep from S1 against its plain version
    replaying the kernel's recorded decisions: every env's qpos, qvel (and
    act) within rel 5e-4, except the ties of _tie_envs, read along both
    trajectories: the margins at the plain version's every forward and at
    the kernel's substep starts, the Newton disagreements at those starts
    (the kernel's and the plain forward of the kernel's own state) that
    the float64 witness settles, the envs parted by the replay itself, and
    the envs whose versions part at one of those starts on a plane-mesh
    support-vertex tie there (_vertex_ties).

    The replay forces on the plain version's state the decisions the
    kernel made at its own; once float32 rounding parts the trajectories
    (~1e-6), a row's recorded Hessian decision can sit on the far side of
    its test there and move the plain solve away from that state's
    solution (tools/megastep_parting.py; PERF.md). Such an env counts as a
    tie only where the replay made such a decision (a row decision the
    plain version's own test at that step does not make) and the kernel
    is shown right without it: its control step lies within rel 5e-4 of
    the plain version's on its own decisions, and at every forward of the
    replayed run the kernel's own forward of that state agrees with the
    plain version replaying it (the same active slots, qacc within rel
    5e-4), with no unsettled disagreement at the kernel's substep starts.
    At a forward where the two rank tied pairs of a top-K differently
    (_rank_ties), the plain version replays the kernel's decisions on
    swapped rows; there the kernel agrees where the plain version with
    its slots in the kernel's order agrees with it. The error printed and
    returned for it stays the replayed comparison's.

    `on_forward(o, j, dec)` sees the replayed run's forward j. Returns
    (ks, the largest error over the held envs, the tie count, the
    replay-parted count, {field: (per-env error, scale)}, dec)."""
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm

    E, dev = S1.qpos.shape[0], S1.qpos.device
    per = hm.forwards_per_step(m)
    dec = torch.zeros((E, per * n, hm.decision_width(m)), dtype=torch.int32,
                      device=dev)
    ks = hm.mega_step_n(m, S1, n, decisions=dec)
    gaps, starts = [], []
    agree = torch.ones(E, dtype=torch.bool, device=dev)
    ranked = torch.zeros(E, dtype=torch.bool, device=dev)

    def observe(o):
        nonlocal agree, ranked
        if len(gaps) % per == 0:  # a substep's first forward
            starts.append(o.qvel)
        gaps.append(_margin_gap(m, o))
        fk = hm.mega_forward(m, o)
        fp = hm.mega_forward_plain(m, o, replay=(
            fk.solver_niter, fk.solver_taken, fk.solver_ls, fk.solver_rows))
        act_k = fk.contact.dist < fk.contact.includemargin
        act_p = fp.contact.dist < fp.contact.includemargin
        ok = (torch.all(act_k == act_p, dim=1)
              & ((fk.qacc - fp.qacc).abs().amax(1)
                 <= 5e-4 * float(fp.qacc.abs().max())))
        if not bool(ok.all()):
            # the two forwards of this state rank tied pairs differently,
            # so the kernel's decisions are replayed on swapped rows: the
            # kernel agrees where the plain version in its slot order
            # agrees with it (_rank_ties)
            rank = _rank_ties(torch, m, o, fk, fp, ~ok)
            ranked |= rank
            ok |= rank
        agree &= ok
        if on_forward is not None:
            on_forward(o, len(gaps) - 1, dec)

    records = []
    rs = hm.mega_step_n_plain(m, S1, n, replay=dec, on_forward=observe,
                              records=records)
    # the replayed row decisions that the plain version's own tests at its
    # state do not make, per env over the whole run (_row_departures)
    departed = torch.stack([((r["rows"] ^ r["own_rows"]) != 0).flatten(1)
                            .any(1) for r in records]).any(0)
    # along the kernel's own trajectory (the megastep is deterministic per
    # env): its state after k substeps, the margins there, and whether the
    # kernel's and the plain forward of that same state disagree, each
    # disagreement settled or not by the float64 witness (_newton_witness)
    kgaps = []
    apart = torch.zeros(E, dtype=torch.bool, device=dev)
    settled = torch.ones(E, dtype=torch.bool, device=dev)
    vertex = torch.zeros(E, dtype=torch.bool, device=dev)
    drift = []  # qvel error between the two at each substep's start
    for k in range(n):
        Sk = S1 if k == 0 else hm.mega_step_n(m, S1, k)
        drift.append((Sk.qvel - starts[k]).abs().amax(1))
        fk = hm.mega_forward(m, Sk, points=True)
        fp = hm.mega_forward_plain(
            m, Sk, replay=(fk.solver_niter, fk.solver_taken, fk.solver_ls,
                           fk.solver_rows))
        kgaps.append(_margin_gap(m, fk))
        a, w = _newton_witness(torch, m, Sk, fk, fp)
        apart |= a
        settled &= ~a | w
        if bool(a.any()):  # parted at this shared state on a vertex tie
            vertex |= _vertex_ties(torch, m, Sk, fk, fp, a)
    ro = hm.mega_step_n_plain(m, S1, n)  # the plain version's own decisions
    held = torch.ones(E, dtype=torch.bool, device=dev)
    held_own = torch.ones(E, dtype=torch.bool, device=dev)
    step_errs = {}
    for name in ("qpos", "qvel") + (("act",) if m.na else ()):
        got, ref, own = (getattr(x, name) for x in (ks, rs, ro))
        for side, t in (("kernel", got), ("plain version", ref)):
            assert bool(torch.isfinite(t).all()), (
                f"megastep {what}: the {side}'s {name} is not finite in "
                f"{int((~torch.isfinite(t).all(1)).sum())} envs")
        err = (got - ref).abs().max(dim=1).values
        scl = float(ref.abs().max()) + 1e-9
        held &= err <= 5e-4 * scl
        held_own &= ((got - own).abs().max(dim=1).values
                     <= 5e-4 * (float(own.abs().max()) + 1e-9))
        step_errs[name] = (err, scl)
    by_replay = ~held & held_own & agree & settled & departed
    rel = torch.stack([e / s for e, s in step_errs.values()]).amax(0)
    gap = torch.stack(gaps).min(dim=0).values.minimum(
        torch.stack(kgaps).min(dim=0).values)
    for env in torch.nonzero(~held).flatten().tolist()[:SHOW_ENVS]:
        print(f"  megastep {what}: env {env} qvel error at each substep's "
              f"start " + " ".join(f"{float(d[env]):.2g}" for d in drift)
              + f"; row decisions the replay forced: {bool(departed[env])}"
              f", the kernel within rel 5e-4 of the plain version on its "
              f"own decisions: {bool(held_own[env])}, agrees with it at "
              f"every state of the replayed run: {bool(agree[env])} (on "
              f"a top-K rank tie at one of them: {bool(ranked[env])})")
    ties = _tie_envs(torch, held, gap, E, f"megastep {what}", rel,
                     apart & settled, by_replay, vertex)
    # the error over the envs held to the tolerance (all but the ties)
    e = max(float(e[held].max()) for e, _ in step_errs.values())
    return ks, e, ties, int(by_replay.sum()), step_errs, dec


def _muscle_flops(model):
    """Float operations the tendon and muscle stage needs per env-forward
    (csrc/mega.cu muscle_block), each piece once: every site from its
    body's frame (18), every segment's geometry (difference, com offsets,
    length, unit vector and the two crosses: 37), its velocity dots (25)
    and its wrench sums (24); per muscle the activation dynamics and the
    FLV law with their clamps (84); per (body, dof) pair of a chain the
    projection of the body's wrench (12); per dof the sum into
    qfrc_smooth. The kernel walks the segments twice and so recomputes the
    sites and the geometry; that repeat is not counted."""
    mp = model.plan.mp
    if mp is None:
        return 0
    return (18 * mp.ns + (37 + 25 + 24) * len(mp.i_seg) + 84 * mp.nmus
            + 12 * int(model.plan.dofmask[1:].sum()) + model.nv)


def _affine_flops(plan):
    """Float operations of the smooth stage's affine terms per env-forward
    (csrc/forward_core.cuh affine_force): per joint actuator with an
    affine gain or bias its length and velocity (2), the gain's two
    products and sums (4), the bias's (4), and their sum with gain c (1)."""
    return sum((3 if a["g_affine"] or a["b_affine"] else 0)
               + 4 * a["g_affine"] + 4 * a["b_affine"]
               for a in plan.sm_acts)


def _cone_census(torch, model, d, qacc):
    """The elliptic contacts' census of one solve, from the plain version's
    rows at data `d` and the solution `qacc`: (active, sticking, in the
    middle zone (E, n) at qacc, dim (n,)), float64."""
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn

    _, problem, ell = hf.newton_problem(model, d)
    J, aref, D, on = problem[0], problem[2], problem[3], problem[6] > 0
    jar = torch.einsum("erv,ev->er", J, qacc.to(J.dtype)) - aref
    _, w, _, cone, _ = hn._cone_zones(jar, D, on, ell)
    return (on[:, ell[0][:, 0]].double(), (w[..., 0] > 0).double(),
            (cone[1] > 0).double(), ell[1].sum(-1).double())


def _forward_flops(torch, model, d, iters, in_kernel_collision=True,
                   qacc=None):
    """Float operations of one forward per env (multiply-add = 2),
    reckoned from csrc/mega.cu (in_kernel_collision: FK and collision in
    the kernel) or csrc/fused.cu (without them) on this state: `d` is the
    staged forward's Data at the same state (contacts, geom poses),
    `iters` the Newton steps each env ran. The data-dependent parts are
    counted from the data: the near plane-mesh pairs' height maps, the
    selected pairs' neighbour walks, the active constraint rows and the
    Newton iterations; the rest is per-env arithmetic of fixed size. A
    plan with euler_dv adds its solve (M qacc, Cholesky, substitutions),
    one whose joint actuators are affine their terms (_affine_flops).
    Elliptic contacts count their dim rows and, per Newton step, each
    active contact's cone zone at each of the solve's 3 + ls_iterations
    evaluations, and the Hessian outer products of its zone at the
    solution (`qacc`, or d.qacc: _cone_census), as csrc/warp_core.cuh
    computes them: none separating, dim sticking, and in the middle zone
    its dim - 1 tangential rows, its rank-1 term and its
    (dim - 1)(dim - 2) / 2 curvature pairs. The extended collision
    (`mega_ell`) counts both sides' poses and keys of
    every pair of a top-K group and the narrowphase of the selected
    pairs, and its plane-mesh group as the plane-only collision's."""
    plan = model.plan
    nv, nb = model.nv, model.nbody
    dev = d.qpos.device
    n = plan.ncon
    act = (d.contact.dist < d.contact.includemargin)[:, :n]  # (E, ncon)
    n_con = act.sum(dim=1).double()
    lim = torch.zeros_like(n_con)
    for r in plan.lim:
        x = d.qpos[:, r["q"]]
        lim += (torch.minimum(x - r["lo"], r["hi"] - x)
                < r["margin"]).double()
    ls = plan.ls_iterations
    if plan.elliptic:
        dims = torch.as_tensor(plan.rows_per, device=dev, dtype=torch.float64)
        crows = (act.double() * dims).sum(dim=1)  # active contact rows
        rot = (act.double() * (dims > 3).double()).sum(dim=1)
        con_rows = crows * (2 * nv + 12) + n_con * (24 * nv + 60) \
            + rot * 18 * nv
        on, stick, mid, dim = _cone_census(
            torch, model, d, d.qacc if qacc is None else qacc)
        pairs = (dim - 1) * (dim - 2) / 2  # curvature outer products
        outers = (stick * dim + mid * (dim + pairs)).sum(dim=1)
        cone = (on * (3 + ls) * (10 * dim + 30)).sum(dim=1) \
            + (mid * (2 * dim * nv + pairs * 3 * nv)).sum(dim=1)
    else:
        crows = 4 * n_con
        con_rows = n_con * (43 * nv + 60)
        outers = crows
        cone = torch.zeros_like(n_con)
    A = plan.ne + plan.nfl + lim + crows  # active rows
    fixed = (nb * 170 + nv * 36 + 6 * nv * (nv + 1) + 2 * nv ** 3 / 3
             + nb * nv * 18 + nv * nv * 6 + nb * 130 + 20 * nv)
    if plan.euler_dv:
        fixed += 4 * nv * nv + nv ** 3 / 3 + 2 * nv * nv
    fixed += _affine_flops(plan)
    rows = (plan.ne + plan.nfl) * (4 * nv + 40) + lim * (2 * nv + 40) \
        + con_rows
    per_iter = (4 * nv * nv + nv * nv / 2 + 2 * nv ** 3 / 3 + 4 * nv * nv
                + 12 * nv + A * (6 * nv + 14 + 8 * ls + 8)
                + (A - crows + outers) * nv * (nv + 1) + cone)
    newton = (2 * (A * (2 * nv + 6) + 2 * nv * nv + 4 * nv)
              + iters.double() * per_iter + A * (4 * nv + 6))
    total = fixed + rows + newton
    if not in_kernel_collision:
        return total
    total = total + _muscle_flops(model)
    if plan.mega_ell:
        # per pair side a pose (63), per ranked pair its key (25), per
        # selected pair its narrowphase (by kind, from csrc/mega.cu); the
        # plane-mesh group as the plane-only collision's, with the slots'
        # generic fields (the plane's frame, 40 per selected pair)
        narrow = (20, 60, 150, 200, 40, 60, 100, 120)
        col = nb * 130 + model.njnt * 160
        for g in plan.ext:
            P = len(g["ints"])
            if g["kind"] == 8:
                col = col + _mesh_flops(torch, plan.ext_mesh, d, act) \
                    + 40 * g["k"]
                continue
            if g["k"] < P:
                col += P * (2 * 63 + 25) * g["k"]
            col += g["k"] * (2 * 63 + narrow[g["kind"]])
        return total + col
    # FK; per plane-box and plane-cylinder pair a pose and, ranked (k <
    # P), its support key (88); per selected pair its pose and slots (the
    # box's corners and 4 argmin rounds 360, the cylinder's rim points
    # 213); the plane-mesh pairs' bounds, height maps and manifolds
    col = nb * 130 + model.njnt * 160
    for g in plan.groups:
        P, k = len(g["pairs"]), g["k"]
        if g["kind"] != "mesh":
            col += (88 * P if k < P else 0) + k * (
                360 if g["kind"] == "box" else 213)
    mesh = next((g for g in plan.groups if g["kind"] == "mesh"), None)
    if mesh is None:
        return total + col
    return total + col + _mesh_flops(torch, mesh, d, act)


def _mesh_flops(torch, mesh, d, act, env_id=None):
    """Float operations of a plane-mesh group per env (csrc/mega.cu
    mesh_group) on the staged forward's Data `d` and its active slots
    `act`: every pair's pose and bound (121), the top-k's comparisons, the
    height maps of the pairs whose bound reaches the margin (7 per vertex)
    and each selected pair's neighbour walk and slots (each env's
    variant's tables where the plan holds K > 1)."""
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc

    mk, dev = mesh["mesh"], d.qpos.device
    t = mk.tensors(dev)
    a, b = hc.plane_in_mesh_frame(d.geom_xpos, d.geom_xmat, t.pg1, t.pg2)
    pf = hc.variant_tables(mk, t, env_id)[1]
    lb = hc.extent_bound(pf, a, b)
    V = torch.as_tensor(mk.pair_i[:, 1], device=dev, dtype=torch.float64)
    D = float(mk.pair_i[:, 2].max())
    near = ((lb < pf[..., 0]).double() * V).sum(dim=1) * 7  # height maps
    o = mesh["offset"]
    sel = act[:, o:o + 3 * mesh["k"]:3].sum(dim=1).double()  # slot 0s
    return (121 * mk.P + mesh["k"] * mk.P + near + sel * (23 * D + 166))


def _load(io, root, name, dev, torch):
    """The committed model in configuration `name` (CONFIGS)."""
    leaves, aux = io.read_model_npz(
        root / "loco_mujoco_tpu_torch/assets/humanoid_torque_shape.npz")
    for k, v in CONFIGS[name].items():
        if k.startswith("leaf:"):
            leaves[k[5:]] = leaves[k[5:]].copy()
            leaves[k[5:]][-1, 0] = v
        else:
            aux[k] = v
    return io.model_from_numpy(leaves, aux, device=dev, dtype=torch.float32)


def seeded_draws(model, m_mu, m_a1, E):
    """The main path's seeded start states and control streams (numpy):
    the humanoids' qpos (the torque model's noise, dropped 5-20 mm so feet
    and hulls touch; every humanoid configuration starts there), the
    torque ctrls in [-0.3, 0.3], the muscle ctrls in [0, 1], then from a
    stream of its own (so the earlier draws stay as they were) A1's qpos,
    dropped 5-20 mm, and its motor ctrls within A1_CTRL of 0. Each ctrls
    array is (CONTROL_STEPS, E, nu)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    qpos = model.qpos0.cpu().numpy()[None] + rng.normal(
        scale=0.02, size=(E, model.nq))
    z = int(model.jnt_qposadr[model.names["joint"]["root_z"]])
    qpos[:, z] -= rng.uniform(0.005, 0.02, size=E)
    ctrls = rng.uniform(-0.3, 0.3, size=(CONTROL_STEPS, E, model.nu))
    ctrls_mu = rng.uniform(0.0, 1.0, size=(CONTROL_STEPS, E, m_mu.nu))
    rng_a1 = np.random.default_rng(SEED + 1)
    qpos_a1 = m_a1.qpos0.cpu().numpy()[None] + rng_a1.normal(
        scale=0.02, size=(E, m_a1.nq))
    z_a1 = int(m_a1.jnt_qposadr[m_a1.names["joint"]["trunk_tz"]])
    qpos_a1[:, z_a1] = float(m_a1.qpos0[z_a1]) - rng_a1.uniform(
        0.005, 0.02, size=E)
    ctrls_a1 = rng_a1.uniform(-A1_CTRL, A1_CTRL,
                              size=(CONTROL_STEPS, E, m_a1.nu))
    return qpos, ctrls, ctrls_mu, qpos_a1, ctrls_a1


def seeded_a1pos(m, E):
    """A1 position mode's seeded start state and targets (numpy), from a
    stream of its own: qpos0 with the torque model's noise, the trunk
    dropped 5-20 mm, and the servos' targets uniform in their ctrlrange
    (the joint ranges), (CONTROL_STEPS, E, nu)."""
    import numpy as np

    rng = np.random.default_rng(SEED + A1POS_SEED)
    qpos = m.qpos0.cpu().numpy()[None] + rng.normal(scale=0.02,
                                                    size=(E, m.nq))
    z = int(m.jnt_qposadr[m.names["joint"]["trunk_tz"]])
    qpos[:, z] = float(m.qpos0[z]) - rng.uniform(0.005, 0.02, size=E)
    cr = m.actuator_ctrlrange.double().cpu().numpy()
    return qpos, rng.uniform(cr[:, 0], cr[:, 1],
                             size=(CONTROL_STEPS, E, m.nu))


def seeded_biped(m, seed, E):
    """A biped's seeded start state and controls (numpy), from a stream of
    its own (`BIPEDS`): qpos0 with the torque model's noise, the pelvis
    dropped 5-20 mm, and motor ctrls in [-0.3, 0.3], (CONTROL_STEPS, E,
    nu)."""
    import numpy as np

    rng = np.random.default_rng(SEED + seed)
    qpos = m.qpos0.cpu().numpy()[None] + rng.normal(scale=0.02,
                                                    size=(E, m.nq))
    z = int(m.jnt_qposadr[m.names["joint"]["pelvis_tz"]])
    qpos[:, z] = float(m.qpos0[z]) - rng.uniform(0.005, 0.02, size=E)
    return qpos, rng.uniform(-0.3, 0.3, size=(CONTROL_STEPS, E, m.nu))


# ---- the env layer (LocoEnv) on the committed stand-ins --------------------
ENV_HORIZON = 8  # control steps per episode: the auto-reset runs in the phase


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU", file=sys.stderr)
        return 2
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.envs.standins import (damping_dr,
                                                     load_standin, make_env,
                                                     standin_kind)
    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import constraint as con
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_layout as lay
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn
    from loco_mujoco_tpu_torch.ops import kernels, kinematics, solver
    from loco_mujoco_tpu_torch.ops.plan import (RESIDENT_FLOOR, fused_launch,
                                                mega_launch, solve_launch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    print(f"nvidia-smi: {card}")

    # ---- build -------------------------------------------------------------
    marks = [("build", time.perf_counter())]

    def phase(name):
        """Prints the wall seconds of the phase that ends here, so that
        the run's time can be read by phase."""
        now = time.perf_counter()
        print(f"phase {marks[-1][0]}: {now - marks[-1][1]:.1f} s")
        marks.append((name, now))

    build_s = kernels.build_all()
    libs = kernels.libraries()
    print(f"kernel build: {build_s:.1f} s ("
          + ", ".join("-".join([n, *d]) for n, d in libs) + ")")
    for name, defines in libs:
        log = kernels.ptxas_log(name, defines)
        label = "-".join([name, *defines])
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"  ptxas {label}: {line.strip()}")

    # ---- models and state --------------------------------------------------
    phase("models and state")
    root = Path(__file__).resolve().parent
    models = {name: _load(io, root, name, dev, torch) for name in CONFIGS}
    model, m_eu, m_wide = models["rk4"], models["euler"], models["wide"]
    m_mu = io.load_model_npz(root / MUSCLE_ASSET, device=dev)
    m_a1 = io.load_model_npz(root / A1_ASSET, device=dev)
    bipeds = {name: io.load_model_npz(root / asset, device=dev)
              for name, (asset, _) in BIPEDS.items()}
    m_h1, m_at = bipeds["h1"], bipeds["atlas"]
    m_g1 = io.load_model_npz(root / G1[0], device=dev)
    m_a1p = load_standin("a1pos", device=dev)
    m_g1a = load_standin("g1arms", device=dev)
    leaves, aux = io.read_model_npz(root / G1ARMS[0])
    aux.update(G1ARMS_WIDE)
    m_g1a_wide = io.model_from_numpy(leaves, aux, device=dev,
                                     dtype=torch.float32)
    arms = {name: load_standin(name, device=dev) for name in ARMS}
    m_h1a, m_ata = arms["h1arms"], arms["atlasarms"]
    kp = {name: load_standin(name, device=dev) for name in KP}
    m_ta, m_g1k = kp["talos"], kp["g1kp"]
    mesh_groups = [i for i, g in enumerate(model.groups)
                   if coll.is_plane_mesh(g)]
    assert mesh_groups and all(model.mesh_kernel[i] is not None
                               for i in mesh_groups), "mesh group off kernel"
    plans = {n: m.plan for n, m in models.items()}
    assert plans["rk4"].mega and not plans["rk4"].euler_dv
    assert plans["euler"].mega and plans["euler"].euler_dv
    assert not plans["fric"].mega and plans["fric"].pack_w == 7
    assert not plans["solref"].mega and plans["solref"].pack_w == 26
    assert plans["wide"] is None, "the wide configuration has a plan"
    mu = m_mu.plan
    assert mu.mega and mu.euler_dv and not mu.smooth and mu.mp is not None
    pa1 = m_a1.plan
    assert pa1.mega and pa1.mega_ell and pa1.elliptic and pa1.euler_dv
    assert pa1.pack_w == 29 and m_a1.ncon == pa1.ncon, "A1 plan"
    pa1p = m_a1p.plan  # A1's position servos: affine bias in the smooth stage
    assert pa1p.mega_ell and pa1p.elliptic and pa1p.euler_dv and pa1p.smooth
    assert hm.ext_mode(pa1p) == 1 and standin_kind(m_a1p) == "a1"
    assert all(a["b_affine"] for a in pa1p.sm_acts), "a1pos servos"
    for name, m in bipeds.items():  # the plane-only plan with cylinders
        p = m.plan
        assert p.mega and p.uniform and not p.elliptic and not p.mega_ell
        assert "cyl" in [g["kind"] for g in p.groups], name
    assert m_h1.plan.euler_dv and hm.forwards_per_step(m_at) == 4
    pg1 = m_g1.plan  # the extended collision with pyramidal rows
    assert pg1.mega and pg1.mega_ell and not pg1.elliptic and pg1.euler_dv
    assert hm.ext_mode(pg1) == 2 and pg1.pack_w == 26 and not pg1.uniform
    g1_mesh = next(i for i, g in enumerate(m_g1.groups)
                   if coll.is_plane_mesh(g))
    assert m_g1.mesh_kernel[g1_mesh] is not None, "G1 mesh group off kernel"
    pg1a = m_g1a.plan  # G1 with its arms: the second compiled width
    assert m_g1a.nv == 29 and pg1a.nvm == 32 and hm.ext_mode(pg1a) == 2
    assert pg1a.mega and pg1a.mega_ell and not pg1a.elliptic and pg1a.euler_dv
    assert mega_launch(pg1a).j_global, "G1 with arms: J in shared memory"
    assert all(m_g1a.mesh_kernel[i] is not None for i, g in enumerate(
        m_g1a.groups) if coll.is_plane_mesh(g)), "G1 arms mesh group"
    assert m_g1a_wide.plan is None and m_g1a_wide.nv == 29
    for name, m in arms.items():  # the wide library's plane-only instance
        p = m.plan
        assert m.nv > 24 and p.nvm == 32 and hm.ext_mode(p) == 0, name
        assert p.mega and p.uniform and not p.mega_ell and not p.elliptic
        assert standin_kind(m) == name[:-4], name
    assert m_h1a.plan.euler_dv and hm.forwards_per_step(m_ata) == 4
    assert not mega_launch(m_h1a.plan).j_global, "H1 arms: J global"
    assert mega_launch(m_ata.plan).j_global, "Atlas arms: J in shared memory"
    for name, m in kp.items():  # a plane-mesh group at k = P: ranked
        gi = next(i for i, g in enumerate(m.groups) if coll.is_plane_mesh(g))
        g, p = m.groups[gi], m.plan
        assert g.k == len(g.pair_ids) and m.mesh_kernel[gi] is None, name
        assert p.mega and p.mesh is not None and p.mesh.k == p.mesh.P, name
    assert hm.ext_mode(m_ta.plan) == 0 and m_ta.plan.euler_dv
    assert standin_kind(m_ta) == "talos" and m_ta.nv == 18
    assert hm.ext_mode(m_g1k.plan) == 2 and m_g1k.plan.euler_dv
    plan = model.mesh_kernel[mesh_groups[0]]
    print(f"model: nv={model.nv}, groups "
          f"{[(g.t2, g.k, len(g.pair_ids)) for g in model.groups]}, "
          f"ncon={model.ncon}; mesh group on the kernels: {plan.P} pairs, "
          f"k={plan.k}, {len(plan.buckets)} vertex buckets; row plan "
          f"{model.plan.nrows} rows; configurations "
          + ", ".join(f"{n} (plan: " + ("none, " + str(m.ncon) + " slots"
                                        if m.plan is None else
                                        f"mega {m.plan.mega}, pack "
                                        f"{m.plan.pack_w}, euler_dv "
                                        f"{m.plan.euler_dv}") + ")"
                      for n, m in models.items())
          + f"; muscle: {mu.mp.nmus} muscles on {m_mu.ntendon} tendons, "
          f"{len(mu.mp.i_seg)} segments, {mu.mp.ns} sites, na {m_mu.na}, "
          f"{mu.nrows} rows; a1: nv={m_a1.nv}, groups "
          f"{[(g.t1, g.t2, g.condim, g.k, len(g.pair_ids)) for g in m_a1.groups]}"
          f", {pa1.ncon} slots, {pa1.nrows} rows, elliptic runs "
          f"{pa1.ell_runs}, impratio {pa1.impratio}; "
          + "; ".join(f"{n}: nv={m.nv}, groups "
                      + str([(g["kind"], g["k"], len(g["pairs"]))
                             for g in m.plan.groups])
                      + f", {m.plan.ncon} slots, {m.plan.nrows} rows, "
                      f"{hm.forwards_per_step(m)} forwards per substep"
                      for n, m in bipeds.items())
          + f"; g1: nv={m_g1.nv}, groups "
          + str([(g.t1, g.t2, g.condim, g.k, len(g.pair_ids))
                 for g in m_g1.groups])
          + f", {pg1.ncon} slots, {pg1.nrows} rows (extended collision, "
          f"pyramidal rows, pack {pg1.pack_w}); a1pos: A1's tree and "
          f"contacts, {m_a1p.nu} position servos (gain "
          f"{pa1p.sm_acts[0]['gain'][0]:g}, bias "
          f"{pa1p.sm_acts[0]['bias']}, force limit "
          f"{float(m_a1p.actuator_forcerange[0, 1]):g}), {pa1p.nrows} rows"
          f"; g1arms: nv={m_g1a.nv} (width {pg1a.nvm}), {m_g1a.nbody} "
          f"bodies, groups "
          + str([(g.t1, g.t2, g.condim, g.k, len(g.pair_ids))
                 for g in m_g1a.groups])
          + f", {pg1a.ncon} slots, {pg1a.nrows} rows; with 20 plane-mesh "
          f"slots {m_g1a_wide.ncon} slots and no plan; "
          + "; ".join(f"{n}: nv={m.nv} (width {m.plan.nvm}), {m.nbody} "
                      f"bodies, groups "
                      + str([(g["kind"], g["k"], len(g["pairs"]))
                             for g in m.plan.groups])
                      + f", {m.plan.ncon} slots, {m.plan.nrows} rows, "
                      f"{hm.forwards_per_step(m)} forwards per substep"
                      for n, m in arms.items())
          + "; " + "; ".join(f"{n}: nv={m.nv}, {m.nbody} bodies, groups "
                             + str([(g.t1, g.t2, g.condim, g.k,
                                     len(g.pair_ids)) for g in m.groups])
                             + f", {m.plan.ncon} slots, {m.plan.nrows} rows "
                             f"(instance {hm.ext_mode(m.plan)}), its "
                             f"plane-mesh group at k = P ({m.plan.mesh.P} "
                             f"hulls) ranked by the mega kernels"
                             for n, m in kp.items()))
    # the mega kernels' launch: a warp per env, its state in shared memory
    for name, m in (("rk4", model), ("euler", m_eu), ("muscle", m_mu),
                    ("a1", m_a1), *bipeds.items(), ("g1", m_g1),
                    ("a1pos", m_a1p), ("g1arms", m_g1a), *arms.items(),
                    *kp.items()):
        launch = mega_launch(m.plan)
        occ = hm.occupancy(m)
        print(f"mega launch {name}: width {m.plan.nvm}, "
              f"{4 * launch.env_floats} bytes of shared "
              f"memory per env, J in "
              f"{'a global scratch' if launch.j_global else 'shared memory'}"
              f", {launch.envs_per_block} envs (warps) per "
              f"block; resident warps per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor): mega "
              f"forward {occ[0]}, megastep {occ[1]} (the launch plan's "
              f"shared-memory bound {launch.resident_warps})")
        assert min(occ) >= RESIDENT_FLOOR, (name, occ)
    kc = _tool("kernel_code")  # its ptxas log parser
    wide = ("LMT_NVM=32",)
    census = {}
    for name in ("mega", "fused", "newton"):
        for fn, props in kc.ptxas(
                kernels.ptxas_log(name, wide).read_text()).items():
            if "registers" in props:
                kind = next(k for k in ("mega_forward_kernel",
                                        "megastep_kernel", "fused_kernel",
                                        "newton_kernel") if k in fn)
                # the template arguments: <EXT, ELL, DAMP> of the mega
                # kernels, <DAMP, ELL> of the fused kernel (Newton's has
                # none)
                args = re.findall(r"L([bi])(\d+)E", fn.split(kind)[1])
                census.setdefault(kind, []).append(
                    "<" + ", ".join(("true" if v == "1" else "false")
                                    if t == "b" else v for t, v in args)
                    + f"> {props['registers']} registers, {props['stack']} "
                    f"B stack, {props['spill_st']} / {props['spill_ld']} B "
                    f"spill stores / loads")
    for name, m in (("g1arms", m_g1a), *arms.items()):
        launch = mega_launch(m.plan)
        j_bytes = launch.nrows * launch.extra["NVJ"] * 4
        print(f"{name} census: {m.plan.ncon} slots, {m.plan.nrows} rows, "
              f"{4 * launch.env_floats} bytes of shared memory per env, "
              f"the rows' J ({m.plan.nrows} x {launch.extra['NVJ']} "
              f"floats, {j_bytes} bytes per env) "
              + (f"in a global scratch of {j_bytes * N_ENVS} bytes at "
                 f"{N_ENVS} envs" if launch.j_global else
                 "in shared memory")
              + f", j_global {launch.j_global}, {launch.resident_warps} "
              f"resident warps per SM by shared memory")
    print("the width-32 instances (plane-only, extended pyramidal; without "
          "and with the damping rows): "
          + "; ".join(f"{k} " + " / ".join(v) for k, v in census.items()))
    # the fused and Newton kernels' launch: a warp per env on the mega
    # kernels' warp core, its state in shared memory (ops/plan.py
    # FusedLaunch, SolveLaunch), the rows' J in shared memory or a global
    # scratch (fused), or read from the operand (Newton)
    fused_models = {"rk4": model, "fric": models["fric"],
                    "solref": models["solref"], "muscle": m_mu, "a1": m_a1,
                    **bipeds, "g1": m_g1, "a1pos": m_a1p, "g1arms": m_g1a,
                    **arms, **kp}
    for name in ("rk4", "a1", "atlasarms", "g1arms"):  # the damping rows
        m = fused_models[name]
        fused_models[name + "_dr"] = m.replace(plan=m.plan.dyn_damping())
    for name, m in fused_models.items():
        launch = fused_launch(m.plan)
        occ = hf.occupancy(m)
        print(f"fused launch {name}: width {m.plan.nvm}, instance <DAMP "
              f"{m.plan.sm_dyn_damping}, ELL {m.plan.elliptic}>, "
              f"{4 * launch.env_floats} bytes of shared memory per env, J in "
              f"{'a global scratch' if launch.j_global else 'shared memory'}"
              f", {launch.envs_per_block} envs (warps) per block; resident "
              f"warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) "
              f"{occ} (the launch plan's shared-memory bound "
              f"{launch.resident_warps})")
        assert occ >= RESIDENT_FLOOR, (name, occ)
    for name, m in (("wide", m_wide), ("g1arms_wide", m_g1a_wide)):
        efc = con.make_constraint(m, fwd.fwd_position(
            m, io.make_data(m, 1), plain=True))
        nefc = efc.J.shape[1]
        ne, nfl = hn.row_class_counts(efc.is_bilateral, efc.is_fl)
        launch = solve_launch(m.nv, nefc, ne, nfl)
        occ = hn.occupancy(m.nv, nefc, ne, nfl)
        print(f"newton launch {name}: nv {m.nv}, {nefc} rows, "
              f"{4 * launch.env_floats} bytes of shared memory per env, J "
              f"read from the operand, {launch.envs_per_block} envs (warps) "
              f"per block; resident warps per SM {occ} (the launch plan's "
              f"shared-memory bound {launch.resident_warps})")
        assert occ >= RESIDENT_FLOOR, (name, occ)
    # the plane-mesh kernel's launch: a warp per env, its scratch in shared
    # memory
    for name, m in (("rk4", model), ("wide", m_wide), ("h1", m_h1),
                    ("g1", m_g1), ("g1arms", m_g1a), ("h1arms", m_h1a)):
        mk = next(p for p in m.mesh_kernel if p is not None)
        print(f"mesh_slots launch {name}: {mk.P} pairs, k {mk.k}, "
              f"{hc.shared_bytes(mk)} bytes of shared memory per env, "
              f"{hc.ENVS_PER_BLOCK} envs (warps) per block; resident warps "
              f"per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) "
              f"{hc.occupancy(mk)}")

    E = N_ENVS
    qpos, ctrls, ctrls_mu, qpos_a1, ctrls_a1 = seeded_draws(model, m_mu, m_a1,
                                                            E)
    qpos_t = torch.as_tensor(qpos, dtype=torch.float32, device=dev)
    data = io.make_data(model, E).replace(qpos=qpos_t)
    qpos_a1_t = torch.as_tensor(qpos_a1, dtype=torch.float32, device=dev)
    biped_draws = {name: seeded_biped(m, BIPEDS[name][1], E)
                   for name, m in bipeds.items()}
    biped_draws["g1"] = seeded_biped(m_g1, G1[1], E)
    biped_draws["g1arms"] = seeded_biped(m_g1a, G1ARMS[1], E)
    for name, m in arms.items():
        biped_draws[name] = seeded_biped(m, ARMS[name], E)
    for name, m in kp.items():
        biped_draws[name] = seeded_biped(m, KP[name], E)
    qpos_a1p, ctrls_a1p = seeded_a1pos(m_a1p, E)

    dr_bipeds = []  # (configuration, its env's damping-rows model), below

    def biped(m):
        """The biped configuration's name of model m (G1 too), or None."""
        return next((n for n, b in (*bipeds.items(), ("g1", m_g1),
                                    ("g1arms", m_g1a), ("g1arms", m_g1a_wide),
                                    *arms.items(), *kp.items(), *dr_bipeds)
                     if b is m), None)

    def ctrl(c, m=model):
        """Control step c's seeded ctrl of model m (the muscle model's in
        [0, 1])."""
        src = (biped_draws[biped(m)][1] if biped(m) else ctrls_a1
               if m is m_a1 else ctrls_a1p if m is m_a1p
               else ctrls_mu if m.na else ctrls)
        return torch.as_tensor(src[c], dtype=torch.float32, device=dev)

    def start(m):
        """The seeded state in model m (every humanoid configuration has
        the same dofs and bodies; A1, its position mode and the bipeds
        their own)."""
        q = (torch.as_tensor(biped_draws[biped(m)][0], dtype=torch.float32,
                             device=dev) if biped(m)
             else qpos_a1_t if m is m_a1
             else torch.as_tensor(qpos_a1p, dtype=torch.float32, device=dev)
             if m is m_a1p else qpos_t)
        return io.make_data(m, E).replace(qpos=q)

    # ---- each kernel of the earlier staged path against its plain version --
    phase("kernel checks")
    d_pos = fwd.fwd_position(model, data, plain=True)
    errs = {}

    def mesh_check(mk, d_pos, what):
        """The plane-mesh kernel against its plain version on a group's
        poses at d_pos (`_mesh_slots_rule`)."""
        err, n_on, n_near = _mesh_slots_rule(
            torch, mk, d_pos.geom_xpos, d_pos.geom_xmat, what)
        print(f"kernel checks ({what}): mesh_slots, {mk.P} pairs, k "
              f"{mk.k}, {E} envs: active slots {n_on}, near pairs "
              f"{n_near}, max err {err:.3g}")
        return err

    errs["mesh_slots"] = mesh_check(plan, d_pos, "torque humanoid")
    d_g1_pos = fwd.fwd_position(m_g1, start(m_g1), plain=True)
    errs["mesh_slots_g1"] = mesh_check(m_g1.mesh_kernel[g1_mesh], d_g1_pos,
                                       "G1")
    errs["mesh_slots_wide"] = mesh_check(
        m_wide.mesh_kernel[mesh_groups[0]],
        fwd.fwd_position(m_wide, start(m_wide), plain=True), "wide, k 34")

    def newton_check(m, d, what):
        """The Newton kernel against its plain version on the rows of the
        staged forward at d. The float32 termination test compares a cost
        improvement with a floor of 1e-6 * scale, below the rounding of
        costs that reach 1e5 in deep contact, so two float32 orders of
        summation can stop an env one Newton step apart. The plain version
        therefore replays the kernel's discrete decisions (`replay`: warm
        start, iteration count, steps taken, the line search's signs and
        each step's Hessian decision of every row, which the warp kernel
        records as the fused and mega kernels do), and the two are held
        step for step on every env: qacc and row forces within rel 5e-4 of
        their largest value; the replayed row decisions depart from the
        plain version's own at the first step in at most 0.5% of the envs
        (_row_departures)."""
        d_acc = fwd.fwd_acceleration(m, fwd.fwd_actuation(
            m, fwd.fwd_velocity(m, d)))
        efc = con.make_constraint(m, d_acc)
        operands, options = solver.newton_inputs(m, d_acc, efc)
        rec, own = {}, {}
        x_k, f_k, it_k, tk_k = hn.solve(*operands, **options, record=rec)
        x_p, f_p, _, _ = hn.newton_plain(
            *operands, **options, replay=(it_k, tk_k, rec["ls"], rec["rows"]),
            record=own)
        _row_departures(torch, SimpleNamespace(solver_rows=rec["rows"]),
                        own["own_rows"], E, f"newton ({what})")
        it_own, tk_own = hn.newton_plain(*operands, **options)[2:]
        e_x = float((x_k - x_p).abs().max())
        e_f = float((f_k - f_p).abs().max())
        sx = float(x_p.abs().max()) + 1e-9
        sf = float(f_p.abs().max()) + 1e-9
        print(f"newton ({what}): nefc={efc.J.shape[1]}; kernel iterations "
              f"mean {float(it_k.float().mean()):.2f}, decisions replayed by "
              f"the plain version; all {E} envs: qacc err {e_x:.3g} (rel "
              f"{e_x / sx:.3g}), force err {e_f:.3g} (rel {e_f / sf:.3g}); "
              f"the plain version's own decisions agree in "
              f"{int(((it_own == it_k) & (tk_own == tk_k)).sum())}/{E} envs")
        assert e_x / sx < 5e-4 and e_f / sf < 5e-4, (e_x, sx, e_f, sf)
        return e_x, operands, options

    e_newton, operands, options = newton_check(
        model, d_pos, "the model's rows at the dropped state")

    # each call site's relayout (all its arrays in one launch) against the
    # plain version, array by array
    lay_tool = _tool("layout_host")
    plain_of = {"moveaxis0_last": lay.moveaxis0_last_plain,
                "moveaxis_last0": lay.moveaxis_last0_plain,
                "to_grouped": lay.transpose_plain,
                "from_grouped": lay.transpose_plain}
    sites = lay_tool.site_arrays(lay, coll, hc, hn, plan, d_pos, operands,
                                 options)
    for role, xs in sites.items():
        kernels.LAUNCHES.clear()
        ys = lay_tool.wrapper(lay, role)(xs)
        assert dict(kernels.LAUNCHES) == {role: 1}, kernels.LAUNCHES
        for x, y in zip(xs, ys):
            assert torch.equal(y, plain_of[role](x)), \
                f"{role} not bit-exact at {tuple(x.shape)}"
        errs[role] = 0.0
    print("kernel checks: relayout bit-exact, one launch per call site ("
          + ", ".join(f"{r} {len(xs)} arrays" for r, xs in sites.items())
          + ")")

    # ---- the staged path (LMT_MEGA=0) -------------------------------------
    phase("staged path")
    def staged_run(m, steps, per_fwd, what):
        """`steps` control steps of `fwd.step`; checks every launch."""
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = start(m)
        for c in range(steps):
            d = d.replace(ctrl=ctrl(c, m))
            for _ in range(SUBSTEPS):
                d = fwd.step(m, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        forwards = hm.forwards_per_step(m) * SUBSTEPS * steps
        assert got == {k: n * forwards for k, n in per_fwd.items()}, got
        assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
        n_con = int((d.contact.dist < d.contact.includemargin).sum())
        assert n_con > 0, "no active contacts"
        rate = E * steps / wall
        ops = lay_tool.device_ops(torch, lambda: fwd.forward(m, d))
        print(f"staged path, {what}: {steps} control steps x {SUBSTEPS} "
              f"substeps ({forwards // (steps * SUBSTEPS)} forwards each), "
              f"{E} envs in {wall:.2f} s = {rate:.0f} env-steps/s ({card}); "
              f"active contacts {n_con}; launches per control step "
              f"{ {k: v // steps for k, v in sorted(got.items())} }; per "
              f"forward (torch.profiler) "
              + (f"{ops[0]} kernels, {ops[1]} copies and fills ({ops[2]} "
                 f"from pageable host memory)" if sum(ops) else
                 "not measured"))
        return d, got, rate, ops[0]

    # one plane-mesh launch per kernel-gated group and forward, no relayout
    per_fused = {"fused": 1, "mesh_slots": len(mesh_groups)}
    per_newton = {"newton": 1, "mesh_slots": len(mesh_groups)}
    with _staged_path():
        d_staged, staged_launches, staged_rate, staged_ops = staged_run(
            model, STAGED_STEPS, per_fused, "RK4 through the fused kernel")
        d_staged_eu, staged_eu_launches, staged_eu_rate, _ = staged_run(
            m_eu, STAGED_STEPS, per_fused, "Euler through the fused kernel")
        d_staged_mu, staged_mu_launches, staged_mu_rate, _ = staged_run(
            m_mu, STAGED_STEPS, per_fused,
            "muscle Euler through the fused kernel (non-smooth layout)")
        d_staged_a1, staged_a1_launches, staged_a1_rate, staged_a1_ops = \
            staged_run(m_a1, STAGED_STEPS, {"fused": 1},
                       "A1 Euler through torch collision and the fused "
                       "kernel (elliptic layout)")
        d_staged_h1, staged_h1_launches, staged_h1_rate, _ = staged_run(
            m_h1, STAGED_STEPS, per_fused, "H1 Euler through the fused "
            "kernel")
        d_staged_at, staged_at_launches, staged_at_rate, _ = staged_run(
            m_at, STAGED_STEPS, {"fused": 1}, "Atlas RK4 through torch "
            "collision and the fused kernel")
        d_staged_g1, staged_g1_launches, staged_g1_rate, staged_g1_ops = \
            staged_run(m_g1, STAGED_STEPS, per_fused, "G1 Euler through the "
                       "plane-mesh kernel, torch narrowphases and the fused "
                       "kernel (26-float pack)")
        d_staged_a1p, staged_a1p_launches, staged_a1p_rate, _ = staged_run(
            m_a1p, STAGED_STEPS, {"fused": 1}, "A1 position Euler through "
            "torch collision and the fused kernel (elliptic layout, the "
            "servos' affine bias in its smooth stage)")
        d_wide, wide_launches, wide_rate, wide_ops = staged_run(
            m_wide, WIDE_STEPS, per_newton,
            f"RK4, no plan ({m_wide.ncon} slots), through the Newton kernel")
        d_staged_g1a, staged_g1a_launches, staged_g1a_rate, staged_g1a_ops = \
            staged_run(m_g1a, WIDE_STEPS, per_fused, "G1 with arms Euler "
                       "through the plane-mesh kernel, torch narrowphases "
                       "and the fused kernel at width 32 (26-float pack)")
        d_g1a_wide, g1a_wide_launches, g1a_wide_rate, _ = staged_run(
            m_g1a_wide, WIDE_STEPS, {"newton": 1},
            f"G1 with arms Euler, no plan ({m_g1a_wide.ncon} slots), "
            f"through the Newton kernel at width 32")
        # H1 and Atlas with their arms: the fused kernel at width 32 (H1's
        # plane-mesh group on the plane-mesh kernel)
        d_staged_h1a, staged_h1a_launches, staged_h1a_rate, _ = staged_run(
            m_h1a, WIDE_STEPS, per_fused, "H1 with arms Euler through the "
            "fused kernel at width 32")
        d_staged_ata, staged_ata_launches, staged_ata_rate, _ = staged_run(
            m_ata, WIDE_STEPS, {"fused": 1}, "Atlas with arms RK4 through "
            "torch collision and the fused kernel at width 32")
        # Talos: its plane-mesh group at k = P keeps the staged path's
        # pair order in torch (no plane-mesh kernel), the fused kernel
        d_staged_ta, staged_ta_launches, staged_ta_rate, staged_ta_ops = \
            staged_run(m_ta, STAGED_STEPS, {"fused": 1}, "Talos Euler "
                       "through torch collision (its plane-mesh group at "
                       "k = P in pair order) and the fused kernel")

        # one staged forward against the all-plain forward
        d = d_staged
        f_kern = fwd.forward(model, d)
        f_plain = fwd.forward(model, d, plain=True)
        same = (f_kern.solver_niter == f_plain.solver_niter) & torch.all(
            (f_kern.contact.dist < f_kern.contact.includemargin)
            == (f_plain.contact.dist < f_plain.contact.includemargin), dim=1)
        diff = (f_kern.qacc - f_plain.qacc).abs()
        # the all-plain forward runs its own termination (see the Newton
        # check above): compare the envs that stop at the same count, at
        # least 30%
        assert same.float().mean() >= 0.3, int(same.sum())
        e_fwd = float(diff[same].max())
        s_fwd = float(f_plain.qacc.abs().max()) + 1e-9
        assert e_fwd / s_fwd < 5e-4, (e_fwd, s_fwd)
        print(f"staged forward vs all-plain forward: {int(same.sum())}/{E} "
              f"envs with the same contact set and Newton iterations, there "
              f"qacc max err {e_fwd:.3g} (rel {e_fwd / s_fwd:.3g}); all envs "
              f"{float(diff.max()):.3g}")
    # the standalone Newton kernel at the end state of its own path
    d_wide_pos = fwd.fwd_position(m_wide, d_wide)
    errs["newton"] = max(e_newton, newton_check(
        m_wide, d_wide_pos, "no-plan path's end state")[0])
    # and at width 32, at the end state of G1 with its arms' no-plan path
    d_g1a_wide_pos = fwd.fwd_position(m_g1a_wide, d_g1a_wide)
    errs["newton_g1arms"] = newton_check(
        m_g1a_wide, d_g1a_wide_pos, "G1 with arms, no-plan path's end state, "
        "width 32")[0]

    # ---- the main path: reset forward, then step_n per control step -----
    phase("main path")
    def main_run(m, what):
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = fwd.forward(m, start(m))  # the env reset's forward
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for c in range(CONTROL_STEPS):
            d = fwd.step_n(m, d.replace(ctrl=ctrl(c, m)), SUBSTEPS)
            if c == 0:
                first = d  # the state after the first control step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = dict(kernels.LAUNCHES)
        assert got == {"mega_forward": 1, "megastep": CONTROL_STEPS}, got
        assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
        if m.na:
            assert torch.isfinite(d.act).all()
            assert bool(((d.act >= 0) & (d.act <= 1)).all()), "act range"
        assert torch.allclose(d.time, data.time + CONTROL_STEPS * SUBSTEPS
                              * m.opt.timestep)
        f_end = fwd.forward(m, d)
        n_con = int((f_end.contact.dist < f_end.contact.includemargin).sum())
        assert n_con > 0, "no active contacts"
        rate = E * CONTROL_STEPS / wall
        print(f"main path, {what}: reset forward {1e3 * (t1 - t0):.2f} ms, "
              f"then {CONTROL_STEPS} control steps x {SUBSTEPS} substeps, "
              f"{E} envs in {wall:.3f} s = {rate:.0f} env-steps/s ({card}); "
              f"active contacts at the end {n_con} ({n_con / E:.2f} per "
              f"env); launches {got}")
        return d, got, rate, first

    S, launches, env_steps, _ = main_run(model, "RK4")
    S_eu, launches_eu, env_steps_eu, _ = main_run(m_eu, "Euler")
    S_mu, launches_mu, env_steps_mu, S_mu_c = main_run(m_mu, "muscle Euler")
    S_a1, launches_a1, env_steps_a1, S_a1_c = main_run(
        m_a1, "A1 Euler (elliptic cones, extended collision)")
    S_h1, launches_h1, env_steps_h1, _ = main_run(
        m_h1, "H1 Euler (plane-cylinder pairs in order, plane-mesh)")
    S_at, launches_at, env_steps_at, _ = main_run(
        m_at, "Atlas RK4 (top-K plane-cylinder and plane-box)")
    S_g1, launches_g1, env_steps_g1, _ = main_run(
        m_g1, "G1 Euler (extended collision: pyramidal rows, plane-mesh and "
        "self groups)")
    S_a1p, launches_a1p, env_steps_a1p, S_a1p_c = main_run(
        m_a1p, "A1 position Euler (elliptic cones, extended collision, the "
        "servos' affine bias)")
    S_g1a, launches_g1a, env_steps_g1a, _ = main_run(
        m_g1a, "G1 with arms Euler (width 32: the extended pyramidal "
        "instance, J in a global scratch)")
    S_h1a, launches_h1a, env_steps_h1a, _ = main_run(
        m_h1a, "H1 with arms Euler (width 32: the plane-only instance, J in "
        "shared memory)")
    S_ata, launches_ata, env_steps_ata, _ = main_run(
        m_ata, "Atlas with arms RK4 (width 32: the plane-only instance, J in "
        "a global scratch)")
    S_ta, launches_ta, env_steps_ta, _ = main_run(
        m_ta, "Talos Euler (the plane-only instance, its plane-mesh group at "
        "k = P ranked)")
    S_g1k, launches_g1k, env_steps_g1k, _ = main_run(
        m_g1k, "G1 at k = P Euler (the extended pyramidal instance, its "
        "plane-mesh group at k = P ranked)")
    print(f"muscle activations at the end: mean "
          f"{float(S_mu.act.mean()):.4f}, min {float(S_mu.act.min()):.4f}, "
          f"max {float(S_mu.act.max()):.4f}")

    # ---- the env layer: LocoEnv.reset_batch / step_batch -----------------
    phase("env layer")
    # The HumanoidTorque-shaped env (RK4, 10 substeps) at 4096 envs, without
    # and with joint-damping randomization (the damping rows' plan variant
    # in the mega forward and the megastep), and A1's env with it (Euler
    # with per-env damping has no megastep: each substep is one mega
    # forward with the rows, then the implicit damping per env in torch);
    # random trajectory starts, seeded actions, episodes of ENV_HORIZON
    # control steps (the auto-reset merge runs); counters zeroed just
    # before each run and read just after.
    import numpy as np

    env_acts = np.random.default_rng(SEED + 7).uniform(
        -0.3, 0.3, size=(CONTROL_STEPS, E, model.nu))
    env_acts_a1 = np.random.default_rng(SEED + 8).uniform(
        -A1_CTRL, A1_CTRL, size=(CONTROL_STEPS, E, m_a1.nu))
    env_acts_g1 = np.random.default_rng(SEED + 9).uniform(
        -0.3, 0.3, size=(CONTROL_STEPS, E, m_g1.nu))

    def act_t(acts, c):
        return torch.as_tensor(acts[c], dtype=torch.float32, device=dev)

    def env_run(env, acts, steps, expect, what, quiet=False):
        """reset_batch(E), then `steps` step_batch calls; checks the
        launches (`expect`) and the streams (`quiet`: prints nothing)."""
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = env.reset_batch(E, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st0, resets = st, torch.zeros((), dtype=torch.int64, device=dev)
        inputs = []  # each step's start state, for `raw_rate`
        for c in range(steps):
            inputs.append(st)
            st = env.step_batch(st, act_t(acts, c))
            resets = resets + st.done.sum()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = dict(kernels.LAUNCHES)
        assert got == expect, (what, got)
        for name in ("obs", "reward"):
            assert bool(torch.isfinite(getattr(st, name)).all()), name
        assert st.obs.shape == (E, env.obs_dim)
        assert bool(((st.reward >= 0) & (st.reward <= 1)).all()), "reward"
        assert bool(torch.isfinite(st.data.qpos).all())
        rate = E * steps / wall
        n_con0 = int((st0.data.contact.dist
                      < st0.data.contact.includemargin).sum())
        if not quiet:
            print(f"env layer, {what}: reset_batch({E}) {1e3 * (t1 - t0):.2f} "
                  f"ms, then {steps} step_batch calls in {wall:.3f} s = "
                  f"{rate:.0f} env-steps/s ({card}); {int(resets)} env "
                  f"resets (horizon {env.horizon}), active contacts at the "
                  f"reset {n_con0} ({n_con0 / E:.2f} per env), absorbing at "
                  f"the end {int(st.absorbing.sum())}; reward mean "
                  f"{float(st.reward.mean()):.4f}; launches {got}")
        return st, st0, got, rate, inputs

    def raw_rate(env, inputs, acts):
        """`forward.step_n` alone on the env run's own start states (the
        auto-resets of fallen envs included) with the same controls: the
        env layer's overhead is the difference."""
        ds = [env._apply_dr(s.data.replace(
            ctrl=act_t(acts, c) * env.norm_act_delta + env.norm_act_mean),
            s.env_id, s.dr) for c, s in enumerate(inputs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m_, d_ in ds:
            fwd.step_n(m_, d_, SUBSTEPS)
        torch.cuda.synchronize()
        return E * len(ds) / (time.perf_counter() - t0)

    def pairing(env, acts, expect, what):
        """`env_run` of CONTROL_STEPS step_batch calls and `raw_rate` on its
        own start states, in turns, PAIRINGS times (the host clock spreads
        single readings): (the first run's end state, start state and
        launches, the median step_batch rate, the median step_n rate, a
        line of both medians, their spreads and the overhead's)."""
        env_rates, raw_rates, first = [], [], None
        for i in range(PAIRINGS):
            st, st0, got, rate, inputs = env_run(env, acts, CONTROL_STEPS,
                                                 expect, what, quiet=i > 0)
            raw_rates.append(raw_rate(env, inputs, acts))
            env_rates.append(rate)
            del inputs
            first = first or (st, st0, got)
        over = [100 * (r / e - 1) for e, r in zip(env_rates, raw_rates)]
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        line = (f"{med(env_rates):.0f} env-steps/s (spread "
                f"{min(env_rates):.0f}-{max(env_rates):.0f}) against "
                f"{med(raw_rates):.0f} for step_n alone (spread "
                f"{min(raw_rates):.0f}-{max(raw_rates):.0f}), overhead "
                f"median {med(over):.2f}% (spread {min(over):.2f} to "
                f"{max(over):.2f}%), {PAIRINGS} pairings")
        return (*first, med(env_rates), med(raw_rates), line)

    # episodes of ENV_HORIZON control steps run the auto-reset; the rate
    # comparisons with step_n alone take episodes longer than the run, so
    # that both step the same states
    env_resets = make_env(model, horizon=ENV_HORIZON)
    env = make_env(model, horizon=CONTROL_STEPS + 1)
    env_dr = make_env(model, dr=damping_dr(model), horizon=CONTROL_STEPS + 1)
    env_a1_dr = make_env(m_a1, dr=damping_dr(m_a1), horizon=ENV_HORIZON)
    m_dr, m_a1_dr = env_dr.model_dr, env_a1_dr.model_dr
    assert m_dr.plan is model.plan.dyn_damping() and m_dr.plan.mega
    assert m_a1_dr.plan.mega_ell and not m_a1_dr.plan.euler_dv
    assert hm.megastep_mode(m_a1_dr) is None  # the per-substep path
    mega_launches = {"mega_forward": 1, "megastep": CONTROL_STEPS}
    env_run(env_resets, env_acts, CONTROL_STEPS, mega_launches,
            f"RK4, episodes of {ENV_HORIZON} control steps")
    _, _, _, env_rate, raw, pair_rk4 = pairing(
        env, env_acts, mega_launches, "RK4")
    st_dr, _, env_dr_launches, env_dr_rate, raw_dr, pair_dr = pairing(
        env_dr, env_acts, mega_launches, "RK4 with damping randomization")
    st_a1dr, _, env_a1dr_launches, env_a1dr_rate, _ = env_run(
        env_a1_dr, env_acts_a1, CONTROL_STEPS,
        {"mega_forward": 1 + CONTROL_STEPS * SUBSTEPS},
        "A1 Euler with damping randomization (per-substep mega forward)")
    # G1's env (its own fall predicate): through step_n's megastep, and
    # with damping randomization (Euler: the per-substep mega forward with
    # the rows in the extended pyramidal instance), beside step_n alone
    env_g1 = make_env(m_g1, horizon=CONTROL_STEPS + 1)
    env_g1_dr = make_env(m_g1, dr=damping_dr(m_g1),
                         horizon=CONTROL_STEPS + 1)
    m_g1_dr = env_g1_dr.model_dr
    assert standin_kind(m_g1) == "g1"  # G1's own fall predicate
    assert m_g1_dr.plan.mega_ell and hm.megastep_mode(m_g1_dr) is None
    _, _, env_g1_launches, env_g1_rate, raw_g1, pair_g1 = pairing(
        env_g1, env_acts_g1, mega_launches, "G1 Euler")
    st_g1dr, _, env_g1dr_launches, env_g1dr_rate, _ = env_run(
        env_g1_dr, env_acts_g1, CONTROL_STEPS,
        {"mega_forward": 1 + CONTROL_STEPS * SUBSTEPS},
        "G1 Euler with damping randomization (per-substep mega forward)")
    print(f"env layer G1: {pair_g1}; with damping "
          f"randomization {env_g1dr_rate:.0f} (the per-substep mega forward)"
          f" ({card})")
    # A1's position mode: the env unnormalizes its actions into the
    # ctrlrange, so they are the servos' targets over the joint ranges
    env_acts_a1p = np.random.default_rng(SEED + 10).uniform(
        -1.0, 1.0, size=(CONTROL_STEPS, E, m_a1p.nu))
    env_a1p = make_env(m_a1p, horizon=CONTROL_STEPS + 1)
    st_a1p, _, env_a1p_launches, env_a1p_rate, raw_a1p, pair_a1p = pairing(
        env_a1p, env_acts_a1p, mega_launches, "A1 position Euler")
    print(f"env layer A1 position: {pair_a1p} ({card})")
    # G1 with its arms (width 32), without damping randomization
    env_acts_g1a = np.random.default_rng(SEED + 11).uniform(
        -0.3, 0.3, size=(CONTROL_STEPS, E, m_g1a.nu))
    env_g1a = make_env(m_g1a, horizon=CONTROL_STEPS + 1)
    assert standin_kind(m_g1a) == "g1"
    _, _, env_g1a_launches, env_g1a_rate, raw_g1a, pair_g1a = pairing(
        env_g1a, env_acts_g1a, mega_launches, "G1 with arms Euler (width 32)")
    print(f"env layer G1 with arms: {pair_g1a} ({card})")
    # the damping rows at width 32: G1 with its arms (Euler: the wide
    # per-substep mega forward with the rows, extended pyramidal) and
    # Atlas with its arms (RK4: the wide megastep with the rows,
    # plane-only) beside step_n alone; H1 with its arms without
    env_g1a_dr = make_env(m_g1a, dr=damping_dr(m_g1a),
                          horizon=CONTROL_STEPS + 1)
    m_g1a_dr = env_g1a_dr.model_dr
    assert m_g1a_dr.plan.nvm == 32 and m_g1a_dr.plan.sm_dyn_damping
    assert hm.megastep_mode(m_g1a_dr) is None  # the per-substep path
    st_g1adr, _, env_g1adr_launches, env_g1adr_rate, _ = env_run(
        env_g1a_dr, env_acts_g1a, CONTROL_STEPS,
        {"mega_forward": 1 + CONTROL_STEPS * SUBSTEPS},
        "G1 with arms Euler with damping randomization (width 32: the "
        "per-substep mega forward with the rows)")
    env_acts_h1a = np.random.default_rng(SEED + 12).uniform(
        -0.3, 0.3, size=(CONTROL_STEPS, E, m_h1a.nu))
    env_h1a = make_env(m_h1a, horizon=CONTROL_STEPS + 1)
    _, _, env_h1a_launches, env_h1a_rate, raw_h1a, pair_h1a = pairing(
        env_h1a, env_acts_h1a, mega_launches, "H1 with arms Euler (width 32)")
    env_acts_ata = np.random.default_rng(SEED + 13).uniform(
        -0.3, 0.3, size=(CONTROL_STEPS, E, m_ata.nu))
    env_ata_dr = make_env(m_ata, dr=damping_dr(m_ata),
                          horizon=CONTROL_STEPS + 1)
    m_ata_dr = env_ata_dr.model_dr
    assert m_ata_dr.plan.nvm == 32 and m_ata_dr.plan.sm_dyn_damping
    assert hm.megastep_mode(m_ata_dr) is not None  # RK4: the megastep
    dr_bipeds.extend((("atlasarms", m_ata_dr), ("g1arms", m_g1a_dr)))
    st_atadr, _, env_atadr_launches, env_atadr_rate, raw_atadr, pair_atadr = \
        pairing(env_ata_dr, env_acts_ata, mega_launches,
                "Atlas with arms RK4 with damping randomization (width 32: "
                "the megastep with the rows)")
    print(f"env layer H1 with arms: {pair_h1a}; Atlas with arms with damping "
          f"randomization {pair_atadr}; G1 with arms with damping "
          f"randomization {env_g1adr_rate:.0f} (the per-substep mega "
          f"forward) ({card})")
    # Talos's env (its own fall predicate; its plane-mesh group at k = P
    # ranked in the megastep) beside step_n alone
    env_acts_ta = np.random.default_rng(SEED + 14).uniform(
        -0.3, 0.3, size=(CONTROL_STEPS, E, m_ta.nu))
    env_ta = make_env(m_ta, horizon=CONTROL_STEPS + 1)
    _, _, env_ta_launches, env_ta_rate, raw_ta, pair_ta = pairing(
        env_ta, env_acts_ta, mega_launches, "Talos Euler")
    print(f"env layer Talos: {pair_ta} ({card})")
    draws = st_dr.dr["dof_damping"]
    assert torch.equal(st_dr.data.dof_damping, draws)
    assert not torch.equal(draws[0], draws[1]), "one damping draw for all"
    print(f"env layer against step_n alone (same model, start states and "
          f"controls of each step): RK4 {pair_rk4}; with damping "
          f"randomization {pair_dr} ({card})")
    # the damping rows' cost on the megastep: the DR env's end state, with
    # and without its per-env damping (the model's own), in turns
    S_dr = st_dr.data
    S_nodr = S_dr.replace(dof_damping=None)
    ms_turns = [
        _time_ms(torch, lambda: hm.mega_step_n(m, d_, SUBSTEPS), reps=3)
        for m, d_ in ((model, S_nodr), (m_dr, S_dr), (m_dr, S_dr),
                      (model, S_nodr))]
    print(f"megastep per control step at the DR env's end state, without / "
          f"with / with / without the damping rows: "
          + " / ".join(f"{t:.3f}" for t in ms_turns) + f" ms ({card})")
    # and at width 32, at Atlas with its arms' DR env's end state
    S_atadr_end = st_atadr.data
    ms_turns_ata = [
        _time_ms(torch, lambda: hm.mega_step_n(m, d_, SUBSTEPS), reps=3)
        for m, d_ in ((m_ata, S_atadr_end.replace(dof_damping=None)),
                      (m_ata_dr, S_atadr_end), (m_ata_dr, S_atadr_end),
                      (m_ata, S_atadr_end.replace(dof_damping=None)))]
    print(f"megastep per control step at Atlas with arms' DR env's end "
          f"state (width 32), without / with / with / without the damping "
          f"rows: " + " / ".join(f"{t:.3f}" for t in ms_turns_ata)
          + f" ms ({card})")
    # the staged path of both DR envs (LMT_MEGA=0): the fused kernel's
    # smooth and elliptic layouts with the damping rows
    with _staged_path():
        fwd_per_step = 4 * SUBSTEPS
        st_sdr, _, staged_dr_launches, staged_dr_rate, _ = env_run(
            env_dr, env_acts, STAGED_STEPS,
            {k: n * (1 + fwd_per_step * STAGED_STEPS)
             for k, n in per_fused.items()},
            "staged RK4 with damping randomization")
        st_sa1dr, _, staged_a1dr_launches, staged_a1dr_rate, _ = env_run(
            env_a1_dr, env_acts_a1, STAGED_STEPS,
            {"fused": 1 + SUBSTEPS * STAGED_STEPS},
            "staged A1 Euler with damping randomization")
        # and at width 32, one control step each: Atlas with its arms
        # (RK4, the smooth layout) and G1 with its arms (Euler, the
        # 26-float pack, its plane-mesh group on the kernels)
        st_satadr, _, staged_atadr_launches, _, _ = env_run(
            env_ata_dr, env_acts_ata, WIDE_STEPS,
            {"fused": 1 + fwd_per_step * WIDE_STEPS},
            "staged Atlas with arms RK4 with damping randomization (width "
            "32)")
        st_sg1adr, _, staged_g1adr_launches, _, _ = env_run(
            env_g1a_dr, env_acts_g1a, WIDE_STEPS,
            {k: n * (1 + SUBSTEPS * WIDE_STEPS)
             for k, n in per_fused.items()},
            "staged G1 with arms Euler with damping randomization (width "
            "32)")

    # ---- the mega forward and the megastep against their plain versions --
    phase("mega checks")
    # From the main path's end state. The plain version replays the
    # kernel's Newton decisions (see the Newton check above); envs whose
    # active contact set differs may be float32 ties only, and envs with
    # the same set may differ only where the float64 witness settles it
    # for the kernel (_tie_envs, _newton_witness).
    def mega_forward_check(m, S, what):
        k = fwd.forward(m, S)
        own = {}
        r = hm.mega_forward_plain(m, S, replay=(
            k.solver_niter, k.solver_taken, k.solver_ls, k.solver_rows),
            record=own)
        _row_departures(torch, k, own["own_rows"], E, f"mega forward {what}")
        act_k = k.contact.dist < k.contact.includemargin
        act_r = r.contact.dist < r.contact.includemargin
        same = torch.all(act_k == act_r, dim=1)
        gap = torch.minimum(_margin_gap(m, k), _margin_gap(m, r))
        apart, witnessed = _newton_witness(torch, m, S, k, r, envs=same)
        held = same & ~(apart & witnessed)
        ties = _tie_envs(torch, held, gap, E, f"mega forward {what}",
                         newton=apart & witnessed)
        fields = ["qacc", "qfrc_constraint", "efc_force_contact"]
        if m.plan.euler_dv:
            fields.append("euler_dv")
        if m.plan.mp is not None:
            fields.append("act_dot")
        e_qacc, msg = 0.0, []
        for name in fields:
            got, ref = getattr(k, name)[held], getattr(r, name)[held]
            err, scl = float((got - ref).abs().max()), float(ref.abs().max())
            assert err <= 5e-4 * scl, (name, err, scl)
            msg.append(f"{name} rel {err / (scl + 1e-9):.3g}")
            if name == "qacc":
                e_qacc = err
        on = act_r & same[:, None]
        assert torch.equal(k.contact.geom2[on], r.contact.geom2[on]), "geom2"
        assert torch.equal(k.contact.geom1[on], r.contact.geom1[on]), "geom1"
        e_dist = _active_close(k.contact.dist, r.contact.dist, on, 1e-5,
                               "mega dist")
        print(f"mega forward {what} vs plain (replayed decisions): "
              f"{int(act_r.sum())} active slots, {ties} tie envs excluded; "
              + ", ".join(msg) + f"; dist max err {e_dist:.3g}; iterations "
              f"mean {float(k.solver_niter.float().mean()):.2f}")
        return e_qacc

    def megastep_check(m, S, what):
        """One control step of the megastep against its plain version
        (_megastep_rule); returns (error, S1, the flops of each
        forward)."""
        step_flops = []
        S1 = S.replace(ctrl=ctrl(0, m))
        per = hm.forwards_per_step(m)
        _, e, ties, n_replay, step_errs, dec = _megastep_rule(
            torch, m, S1, SUBSTEPS, what,
            on_forward=lambda o, j, dec: step_flops.append(
                _forward_flops(torch, m, o, dec[:, j, 0])))
        held = torch.ones(E, dtype=torch.bool, device=dev)
        for err, scl in step_errs.values():
            held &= err <= 5e-4 * scl
        msg = [f"{name} rel {float(err[held].max()) / scl:.3g} (all envs "
               f"{float(err.max()) / scl:.3g})"
               for name, (err, scl) in step_errs.items()]
        print(f"megastep {what} (1 control step, {per * SUBSTEPS} forwards) "
              f"vs plain (replayed decisions): {ties} tie envs excluded "
              f"({n_replay} parted by the replay); " + ", ".join(msg)
              + f"; iterations mean {float(dec[..., 0].float().mean()):.2f}")
        return e, S1, step_flops

    errs["mega_forward"] = mega_forward_check(model, S, "RK4")
    errs["megastep"], S1, step_flops = megastep_check(model, S, "RK4")
    errs["mega_forward_euler"] = mega_forward_check(m_eu, S_eu, "Euler")
    errs["megastep_euler"], S1_eu, step_flops_eu = megastep_check(
        m_eu, S_eu, "Euler")
    errs["mega_forward_muscle"] = mega_forward_check(m_mu, S_mu, "muscle")
    errs["megastep_muscle"], S1_mu, step_flops_mu = megastep_check(
        m_mu, S_mu, "muscle")
    # The seeded activations lift the muscle humanoids off the floor by the
    # end state; hold both muscle kernels also after the first control
    # step, in deep contact.
    f_c = fwd.forward(m_mu, S_mu_c)
    n_con_c = int((f_c.contact.dist < f_c.contact.includemargin).sum())
    assert n_con_c >= 2 * E, f"muscle state after one step: {n_con_c} contacts"
    print(f"muscle state after the first control step: {n_con_c} active "
          f"contacts ({n_con_c / E:.2f} per env)")
    e_fc = mega_forward_check(m_mu, S_mu_c, "muscle, in contact")
    e_sc, S1_mu_c, step_flops_mu_c = megastep_check(m_mu, S_mu_c,
                                                    "muscle, in contact")
    errs["mega_forward_muscle"] = max(errs["mega_forward_muscle"], e_fc)
    errs["megastep_muscle"] = max(errs["megastep_muscle"], e_sc)
    # A1: the extended collision and the elliptic rows, at the end state
    # (held also after the first control step where the end is
    # contact-light, under 1 contact per env)
    errs["mega_forward_a1"] = mega_forward_check(m_a1, S_a1, "A1")
    errs["megastep_a1"], S1_a1, step_flops_a1 = megastep_check(m_a1, S_a1,
                                                               "A1")
    f_a1 = fwd.forward(m_a1, S_a1)
    n_con_a1 = int((f_a1.contact.dist < f_a1.contact.includemargin).sum())
    act_a1 = f_a1.contact.dist < f_a1.contact.includemargin
    print("A1 end state: active slots per group "
          + str([int(act_a1[:, g.offset:g.offset + g.k * g.slots].sum())
                 for g in m_a1.groups]) + f" ({n_con_a1 / E:.2f} per env)")
    if n_con_a1 < E:
        errs["mega_forward_a1"] = max(errs["mega_forward_a1"],
                                      mega_forward_check(m_a1, S_a1_c,
                                                         "A1, in contact"))
        errs["megastep_a1"] = max(errs["megastep_a1"], megastep_check(
            m_a1, S_a1_c, "A1, in contact")[0])
    # A1's position mode: the servos' affine bias in the extended elliptic
    # instance, held at the end state of its env's 20 step_batch calls (the
    # path its users run: A1's fall predicate resets a trunk past 0.192 rad
    # of tilt), and after the main path's first control step where that is
    # contact-light. step_n alone resets nothing: at its end state the
    # full-range targets have tipped trunks to the Euler root's gimbal lock
    # (trunk_tilt near pi/2, cond(M) ~1e6), where float32 resolves
    # qacc_smooth only to ~2e-3, in the kernel and the plain version alike
    # (ROADMAP Queue 3)
    S_a1p_env = st_a1p.data
    print("A1 position, step_n's end state (no resets): envs at the root's "
          "gimbal lock (|trunk_tilt| within 0.05 of pi/2): "
          f"{int(((S_a1p.qpos[:, 4].abs() - torch.pi / 2).abs() < 0.05).sum())}"
          "; the env's end state (A1's fall predicate resets): "
          f"{int(((S_a1p_env.qpos[:, 4].abs() - torch.pi / 2).abs() < 0.05).sum())}")
    errs["mega_forward_a1pos"] = mega_forward_check(m_a1p, S_a1p_env,
                                                    "A1 position")
    errs["megastep_a1pos"], S1_a1p, step_flops_a1p = megastep_check(
        m_a1p, S_a1p_env, "A1 position")
    f_a1p = fwd.forward(m_a1p, S_a1p_env)
    act_a1p = f_a1p.contact.dist < f_a1p.contact.includemargin
    n_con_a1p = int(act_a1p.sum())
    print("A1 position env's end state: active slots per group "
          + str([int(act_a1p[:, g.offset:g.offset + g.k * g.slots].sum())
                 for g in m_a1p.groups]) + f" ({n_con_a1p / E:.2f} per env)")
    if n_con_a1p < E:
        errs["mega_forward_a1pos"] = max(
            errs["mega_forward_a1pos"],
            mega_forward_check(m_a1p, S_a1p_c, "A1 position, in contact"))
        errs["megastep_a1pos"] = max(errs["megastep_a1pos"], megastep_check(
            m_a1p, S_a1p_c, "A1 position, in contact")[0])
    # H1 and Atlas: the plane-only collision's cylinder branch, at the end
    # state, which must hold a contact in at least 90% of the envs (else
    # the kernels would be held off the floor; the muscle model's case)
    biped_runs = {}
    for name, m, S_ in (("h1", m_h1, S_h1), ("atlas", m_at, S_at)):
        f_ = fwd.forward(m, S_)
        act_ = f_.contact.dist < f_.contact.includemargin
        n_ = int(act_.sum())
        touching = int(act_.any(1).sum())
        print(f"{name} end state: active slots per group "
              + str([int(act_[:, g.offset:g.offset + g.k * g.slots].sum())
                     for g in m.groups]) + f" ({n_ / E:.2f} per env; "
              f"{touching} of {E} envs touch the floor)")
        assert touching >= 0.9 * E, f"{name}: the end state is contact-light"
        errs[f"mega_forward_{name}"] = mega_forward_check(m, S_, name)
        errs[f"megastep_{name}"], S1_, flops_ = megastep_check(m, S_, name)
        biped_runs[name] = (S1_, flops_)
    # G1: the extended collision's pyramidal instance with its plane-mesh
    # and self groups, at the end state (which must touch the floor in 90%
    # of the envs too), and with the damping rows at its DR env's end
    f_ = fwd.forward(m_g1, S_g1)
    act_ = f_.contact.dist < f_.contact.includemargin
    touching = int(act_.any(1).sum())
    print("g1 end state: active slots per group "
          + str([int(act_[:, g.offset:g.offset + g.k * g.slots].sum())
                 for g in m_g1.groups]) + f" ({int(act_.sum()) / E:.2f} per "
          f"env; {touching} of {E} envs touch)")
    assert touching >= 0.9 * E, "g1: the end state is contact-light"
    errs["mega_forward_g1"] = mega_forward_check(m_g1, S_g1, "g1")
    errs["megastep_g1"], S1_g1, step_flops_g1 = megastep_check(m_g1, S_g1,
                                                               "g1")
    S_g1dr = st_g1dr.data
    errs["mega_forward_g1_dr"] = mega_forward_check(m_g1_dr, S_g1dr,
                                                    "G1 damping DR")
    # G1 with its arms: the wide library's extended pyramidal instance, J
    # in a global scratch, at the end state (touching in 90% of the envs)
    f_ = fwd.forward(m_g1a, S_g1a)
    act_ = f_.contact.dist < f_.contact.includemargin
    touching = int(act_.any(1).sum())
    print("g1arms end state: active slots per group "
          + str([int(act_[:, g.offset:g.offset + g.k * g.slots].sum())
                 for g in m_g1a.groups]) + f" ({int(act_.sum()) / E:.2f} per "
          f"env; {touching} of {E} envs touch)")
    assert touching >= 0.9 * E, "g1arms: the end state is contact-light"
    errs["mega_forward_g1arms"] = mega_forward_check(m_g1a, S_g1a, "g1arms")
    errs["megastep_g1arms"], S1_g1a, step_flops_g1a = megastep_check(
        m_g1a, S_g1a, "g1arms")
    # H1 and Atlas with their arms: the wide library's plane-only instance
    # (H1's J in shared memory, Atlas's in the global scratch), at the end
    # state (touching in 90% of the envs)
    arms_runs = {}
    for name, m, S_ in (("h1arms", m_h1a, S_h1a), ("atlasarms", m_ata, S_ata)):
        f_ = fwd.forward(m, S_)
        act_ = f_.contact.dist < f_.contact.includemargin
        touching = int(act_.any(1).sum())
        print(f"{name} end state: active slots per group "
              + str([int(act_[:, g.offset:g.offset + g.k * g.slots].sum())
                     for g in m.groups]) + f" ({int(act_.sum()) / E:.2f} per "
              f"env; {touching} of {E} envs touch)")
        assert touching >= 0.9 * E, f"{name}: the end state is contact-light"
        errs[f"mega_forward_{name}"] = mega_forward_check(m, S_, name)
        errs[f"megastep_{name}"], S1_, flops_ = megastep_check(m, S_, name)
        arms_runs[name] = (S1_, flops_)
    # Talos and G1 at k = P: a plane-mesh group at k = P, which the mega
    # kernels rank (the plane-only and the extended pyramidal instances),
    # at the end state (touching in 90% of the envs)
    kp_runs = {}
    for name, m, S_ in (("talos", m_ta, S_ta), ("g1kp", m_g1k, S_g1k)):
        f_ = fwd.forward(m, S_)
        act_ = f_.contact.dist < f_.contact.includemargin
        touching = int(act_.any(1).sum())
        g = next(g for g in m.groups if coll.is_plane_mesh(g))
        pairs_on = act_[:, g.offset:g.offset + g.k * g.slots:g.slots].sum(1)
        print(f"{name} end state: active slots per group "
              + str([int(act_[:, g_.offset:g_.offset + g_.k * g_.slots].sum())
                     for g_ in m.groups]) + f" ({int(act_.sum()) / E:.2f} per "
              f"env; {touching} of {E} envs touch); envs with 2 or more "
              f"plane-mesh pairs in contact (ranked among each other) "
              f"{int((pairs_on >= 2).sum())}")
        assert touching >= 0.9 * E, f"{name}: the end state is contact-light"
        errs[f"mega_forward_{name}"] = mega_forward_check(m, S_, name)
        errs[f"megastep_{name}"], S1_, flops_ = megastep_check(m, S_, name)
        kp_runs[name] = (S1_, flops_)
    # the damping rows at width 32, at the randomized arms envs' end states:
    # the plane-only mega forward and RK4 megastep (Atlas with its arms)
    # and the extended pyramidal mega forward (G1 with its arms)
    S_atadr, S_g1adr = st_atadr.data, st_g1adr.data
    errs["mega_forward_atlasarms_dr"] = mega_forward_check(
        m_ata_dr, S_atadr, "Atlas arms damping DR")
    errs["megastep_atlasarms_dr"], S1_atadr, step_flops_atadr = \
        megastep_check(m_ata_dr, S_atadr, "Atlas arms damping DR")
    errs["mega_forward_g1arms_dr"] = mega_forward_check(
        m_g1a_dr, S_g1adr, "G1 arms damping DR")
    # the damping rows: the mega forward's plane-only and extended
    # instances and the megastep, at the DR envs' end states
    errs["mega_forward_dr"] = mega_forward_check(m_dr, S_dr,
                                                 "RK4 damping DR")
    errs["megastep_dr"], S1_dr, step_flops_dr = megastep_check(
        m_dr, S_dr, "RK4 damping DR")
    S_a1dr = st_a1dr.data
    errs["mega_forward_a1_dr"] = mega_forward_check(m_a1_dr, S_a1dr,
                                                    "A1 damping DR")

    # ---- the fused kernel against its plain version, four configurations --
    phase("fused checks")
    # At the staged RK4 run's end state, carried into each configuration:
    # both versions read the same FK outputs, contacts and warm start, so
    # their active rows agree by construction and every env is held.
    # The muscle model's non-smooth layout at its own staged run's end
    # state, from the staged stages' outputs.
    # The damping rows (smooth and elliptic layouts) at the staged DR envs'
    # end states, each env's damping carried along.
    fused_in = {}
    models.update(muscle=m_mu, a1=m_a1, dr=m_dr, a1_dr=m_a1_dr, g1=m_g1,
                  a1pos=m_a1p, g1arms=m_g1a, atlasarms_dr=m_ata_dr,
                  g1arms_dr=m_g1a_dr, talos=m_ta, **bipeds, **arms)
    for name in ("rk4", "euler", "fric", "solref", "muscle", "a1", "h1",
                 "atlas", "g1", "dr", "a1_dr", "a1pos", "g1arms", "h1arms",
                 "atlasarms", "atlasarms_dr", "g1arms_dr", "talos"):
        m = models[name]
        src = {"muscle": d_staged_mu, "a1": d_staged_a1, "h1": d_staged_h1,
               "atlas": d_staged_at, "g1": d_staged_g1, "dr": st_sdr.data,
               "a1_dr": st_sa1dr.data, "a1pos": d_staged_a1p,
               "g1arms": d_staged_g1a, "h1arms": d_staged_h1a,
               "atlasarms": d_staged_ata, "atlasarms_dr": st_satadr.data,
               "g1arms_dr": st_sg1adr.data,
               "talos": d_staged_ta}.get(name, d_staged)
        d = io.make_data(m, E).replace(
            qpos=src.qpos, qvel=src.qvel, ctrl=src.ctrl, act=src.act,
            qacc_warmstart=src.qacc_warmstart, dof_damping=src.dof_damping)
        if name == "muscle":
            d = fwd.stages(m, d)
        else:
            d = coll.collision(m, kinematics.kinematics(m, d))
        fused_in[name] = d
        kernels.LAUNCHES.clear()
        k = hf.fused_constraint(m, d)
        assert dict(kernels.LAUNCHES) == {"fused": 1}
        own = {}
        r = hf.fused_constraint_plain(m, d, replay=(
            k.solver_niter, k.solver_taken, k.solver_ls, k.solver_rows),
            solve64=m.plan.elliptic, record=own)
        _row_departures(torch, k, own["own_rows"], E, f"fused {name}")
        fields = ["qacc", "qfrc_constraint", "efc_force_contact"]
        assert (k.euler_dv is None) == (not m.plan.euler_dv)
        if m.plan.euler_dv:
            fields.append("euler_dv")
        held = torch.ones(E, dtype=torch.bool, device=dev)
        per_env = {}
        for f in fields:
            got, ref = getattr(k, f), getattr(r, f)
            err = (got - ref).abs().reshape(E, -1).max(dim=1).values
            scl = float(ref.abs().max()) + 1e-9
            held &= err <= 5e-4 * scl
            per_env[f] = (err, scl)
        ties = 0
        if m.plan.elliptic:  # float32 ties and witnessed Newton envs
            apart, witnessed = _newton_witness(torch, m, d, k, r,
                                               staged=True)
            ties = _tie_envs(torch, held, _margin_gap(m, d), E,
                             f"fused {name}", newton=apart & witnessed)
        else:
            assert bool(held.all()), (f"fused {name}: {int((~held).sum())} "
                                      f"envs differ")
        key = "fused" if name == "rk4" else f"fused_{name}"
        errs[key] = float(per_env["qacc"][0][held].max())
        n_act = int((d.contact.dist < d.contact.includemargin).sum())
        print(f"fused {name} (pack {m.plan.pack_w}) vs plain (replayed "
              f"decisions): {n_act} active slots, {int(held.sum())} of {E} "
              f"envs held, {ties} tie envs excluded; "
              + ", ".join(f"{f} rel {float(e[held].max()) / s:.3g} (all "
                          f"envs {float(e.max()) / s:.3g})"
                          for f, (e, s) in per_env.items())
              + f"; iterations mean "
              f"{float(k.solver_niter.float().mean()):.2f}")

    # ---- stacked model variants: the four 4-ages scalings ----------------
    phase("variants")
    # The torque humanoid at the scalings 0.4, 0.6, 0.8 and 1.0 as stacked
    # model variants (their invweights differ: no row plan, the staged
    # path with the Newton kernel; the plane-mesh kernel with four hull
    # tables, each env reading its variant's), env_id drawn at reset
    from loco_mujoco_tpu_torch.envs.standins import load_variants

    m_vars = load_variants("humanoid4ages", device=dev)
    env_v = make_env(m_vars[0], model_variants=m_vars,
                     horizon=CONTROL_STEPS + 1)
    m_vs = env_v.model_dr
    v_grp = next(i for i, p in enumerate(m_vs.mesh_kernel) if p is not None)
    mk_v = m_vs.mesh_kernel[v_grp]
    assert m_vs.plan is None and env_v.n_variants == 4 and mk_v.K == 4
    n_v = 1 + hm.forwards_per_step(m_vs) * SUBSTEPS * VARIANT_STEPS
    st_v, st_v0, env_v_launches, env_v_rate, _ = env_run(
        env_v, env_acts, VARIANT_STEPS, {"newton": n_v, "mesh_slots": n_v},
        "4-ages variants (K = 4: the Newton kernel, the plane-mesh kernel "
        "with four hull tables)")
    counts = torch.bincount(st_v0.env_id.long(), minlength=4).tolist()
    assert min(counts) > 0, counts
    print(f"variants: envs per scaling at the reset {counts}; varied "
          f"leaves {sorted(m_vs.varied)}; launches per control step "
          f"{ {k: (v - 1) // VARIANT_STEPS for k, v in env_v_launches.items()} }"
          f" and 1 each at the reset ({card})")
    m_ve, _ = env_v._apply_dr(st_v.data, st_v.env_id, st_v.dr)
    d_v = fwd.fwd_position(m_ve, st_v.data)
    ids_v = st_v.env_id.to(torch.int32)
    err, n_on, n_near = _mesh_slots_rule(
        torch, mk_v, d_v.geom_xpos, d_v.geom_xmat, "variants end state",
        env_id=ids_v)
    errs["mesh_slots_variants"] = err
    print(f"kernel checks (variants end state): mesh_slots with {mk_v.K} "
          f"hull tables, {mk_v.P} pairs, k {mk_v.k}, {E} envs: active slots "
          f"{n_on}, near pairs {n_near}, max err {err:.3g}; the K-table "
          f"instance's resident warps per SM {hc.occupancy(mk_v)} (one "
          f"table: {hc.occupancy(m_vars[0].mesh_kernel[v_grp])})")
    e_nv, ops_v, opts_v = newton_check(m_ve, d_v, "variants end state")
    errs["newton_variants"] = e_nv

    # ---- model leaves per env: the Geoms / Inertial / Joints sections ---
    phase("dr_leaves")
    # Masses, inertias and armature per env (each body's mass, the torso's
    # full inertia by the SVD rule, the joints' armature and the knees'
    # stiffness): the row plan without its smooth stage, so the fused
    # kernel's non-smooth layout with each env's cinert and armature; then
    # friction loss per env: no row plan, the Newton kernel
    roots = [j for j in model.names["joint"] if j.startswith("root")]
    leaves_conf = {
        "Default": {"exclude": roots,
                    "Joints": {"armature": {"uniform_range": [0.005, 0.03]}},
                    "Inertial": {"mass": {"uniform_range_delta": 0.5}}},
        "Inertial": {"torso": {"fullinertia": {"uniform_range_delta": 0.02}}},
        "Joints": {f"knee_{s}": {"stiffness": {"uniform_range": [1.0, 5.0]},
                                 "armature": {"uniform_range": [0.005,
                                                                0.03]}}
                   for s in "rl"}}
    env_dl = make_env(model, dr=leaves_conf, horizon=CONTROL_STEPS + 1)
    m_dl = env_dl.model_dr
    assert m_dl.plan is not None and not m_dl.plan.smooth \
        and not m_dl.plan.mega
    n_dl = 1 + hm.forwards_per_step(model) * SUBSTEPS * DR_STEPS
    n_mesh = n_dl * len(mesh_groups)
    with _staged_path():
        st_dl, _, env_dl_launches, env_dl_rate, _ = env_run(
            env_dl, env_acts, DR_STEPS, {"fused": n_dl, "mesh_slots": n_mesh},
            "per-env masses, inertias, armature and stiffness (the fused "
            "kernel's non-smooth layout)")
    m_dle, d_dle = env_dl._apply_dr(st_dl.data, st_dl.env_id, st_dl.dr)
    d_dl = fwd.stages(m_dle, io.make_data(m_dle, E).replace(
        qpos=d_dle.qpos, qvel=d_dle.qvel, ctrl=d_dle.ctrl,
        qacc_warmstart=d_dle.qacc_warmstart))
    kernels.LAUNCHES.clear()
    k = hf.fused_constraint(m_dle, d_dl)
    assert dict(kernels.LAUNCHES) == {"fused": 1}
    own = {}
    r = hf.fused_constraint_plain(m_dle, d_dl, replay=(
        k.solver_niter, k.solver_taken, k.solver_ls, k.solver_rows),
        record=own)
    _row_departures(torch, k, own["own_rows"], E, "fused dr_leaves")
    parts = []
    e_dl = 0.0
    for f in ("qacc", "qfrc_constraint", "efc_force_contact"):
        e = (getattr(k, f) - getattr(r, f)).abs().reshape(E, -1).amax(1)
        scl = float(getattr(r, f).abs().max()) + 1e-9
        n_out = int((e > 5e-4 * scl).sum())
        assert n_out == 0, f"fused dr_leaves {f}: {n_out} envs differ"
        parts.append(f"{f} rel {float(e.max()) / scl:.3g}")
        if f == "qacc":
            e_dl = float(e.max())
    errs["fused_dr_leaves"] = e_dl
    models["dr_leaves"], fused_in["dr_leaves"] = m_dle, d_dl
    print(f"fused dr_leaves (non-smooth layout, per-env cinert and "
          f"armature) vs plain (replayed decisions): all {E} envs held, "
          + ", ".join(parts) + f"; iterations mean "
          f"{float(k.solver_niter.float().mean()):.2f}")
    # the knees' friction loss (the dofs with friction-loss rows)
    floss_conf = {"Joints": {f"knee_{s}": {"frictionloss": {
        "uniform_range": [0.2, 1.0]}} for s in "rl"}}
    env_fl = make_env(model, dr=floss_conf, horizon=CONTROL_STEPS + 1)
    assert env_fl.model_dr.plan is None
    n_fl = 1 + hm.forwards_per_step(model) * SUBSTEPS * FLOSS_STEPS
    st_fl, _, env_fl_launches, env_fl_rate, _ = env_run(
        env_fl, env_acts, FLOSS_STEPS,
        {"newton": n_fl, "mesh_slots": n_fl * len(mesh_groups)},
        "per-env friction loss (no row plan: the Newton kernel)")
    m_fle, d_fle = env_fl._apply_dr(st_fl.data, st_fl.env_id, st_fl.dr)
    e_fl, ops_fl, opts_fl = newton_check(
        m_fle, fwd.fwd_position(m_fle, d_fle), "per-env friction loss end "
        "state")
    errs["newton_dr_floss"] = e_fl

    # ---- timings -----------------------------------------------------------
    phase("timings")
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []
    run_launches = {
        "staged RK4": staged_launches, "staged Euler": staged_eu_launches,
        "staged muscle": staged_mu_launches,
        "no-plan staged RK4": wide_launches, "main RK4": launches,
        "main Euler": launches_eu, "main muscle": launches_mu,
        "staged A1": staged_a1_launches, "main A1": launches_a1,
        "staged H1": staged_h1_launches, "main H1": launches_h1,
        "staged Atlas": staged_at_launches, "main Atlas": launches_at,
        "staged G1": staged_g1_launches, "main G1": launches_g1,
        "env G1 DR": env_g1dr_launches,
        "env RK4 DR": env_dr_launches, "env A1 DR": env_a1dr_launches,
        "staged env RK4 DR": staged_dr_launches,
        "staged env A1 DR": staged_a1dr_launches,
        "staged A1 position": staged_a1p_launches,
        "main A1 position": launches_a1p, "env A1 position": env_a1p_launches,
        "staged G1 arms": staged_g1a_launches, "main G1 arms": launches_g1a,
        "no-plan staged G1 arms": g1a_wide_launches,
        "env G1 arms": env_g1a_launches,
        "staged H1 arms": staged_h1a_launches, "main H1 arms": launches_h1a,
        "env H1 arms": env_h1a_launches,
        "staged Atlas arms": staged_ata_launches, "main Atlas arms":
        launches_ata, "env Atlas arms DR": env_atadr_launches,
        "staged env Atlas arms DR": staged_atadr_launches,
        "env G1 arms DR": env_g1adr_launches,
        "staged env G1 arms DR": staged_g1adr_launches,
        "staged Talos": staged_ta_launches, "main Talos": launches_ta,
        "env Talos": env_ta_launches, "main G1 k=P": launches_g1k,
        "env variants": env_v_launches, "env DR leaves": env_dl_launches,
        "env DR friction loss": env_fl_launches}

    def row(name, kernel, run, source, replaces, ms, plain_ms, nbytes_,
            flops, library_ms=None):
        t, by = _bound(nbytes_, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"loco_mujoco_tpu_torch/csrc/{source}",
            "replaces": f"loco_mujoco_tpu/ops/{replaces}",
            "launches": run_launches[run].get(kernel, 0),
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t, "bound_by": by,
            "library_ms": library_ms})

    # the relayouts and the Newton kernel at the end state of their path
    # (the no-plan staged run): each call site's arrays of one forward, in
    # the one launch of its list form
    d_acc = fwd.fwd_acceleration(m_wide, fwd.fwd_actuation(
        m_wide, fwd.fwd_velocity(m_wide, d_wide_pos)))
    efc = con.make_constraint(m_wide, d_acc)
    operands, options = solver.newton_inputs(m_wide, d_acc, efc)
    wplan = m_wide.mesh_kernel[mesh_groups[0]]
    sites = lay_tool.site_arrays(lay, coll, hc, hn, wplan, d_wide_pos,
                                 operands, options)
    replaces = {"moveaxis0_last": "pallas_layout.py:43",
                "moveaxis_last0": "pallas_layout.py:43",
                "to_grouped": "pallas_layout.py:112",
                "from_grouped": "pallas_layout.py:153"}
    for role, xs in sites.items():
        xs = [t.contiguous() for t in xs]
        tm = lay_tool.site_times(torch, lay, kernels, role, xs)
        row(role, role, "no-plan staged RK4", "layout.cu", replaces[role],
            tm["wrapper_ms"], tm["plain_ms"], 2 * nbytes(*xs), 0,
            tm["library_ms"])
        where = ("the plane-mesh group's arrays, which the one plane-mesh "
                 "kernel reads and writes env-major" if role.startswith(
                     "move") else "the Newton solve's arrays, which the warp "
                 "solve reads env-major") + ": no path launches it"
        print(f"layout {role} ({len(xs)} arrays, {where}): "
              f"the wrapper {tm['wrapper_ms']:.4f} ms, the launch alone "
              f"{tm['launch_alone_ms']:.4f} ms (bound {tm['bound_ms']:.4f} "
              f"ms: {tm['bound_ms'] / tm['launch_alone_ms']:.0%} of the "
              f"bound's rate), "
              f"x.t().contiguous() over the same arrays "
              f"{tm['library_ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms "
              f"({card})")
        host = lay_tool.split(torch, lay, kernels, role,
                              lay_tool.host_arrays(role, xs))
        print(f"layout {role} host split (1000 calls at 128 envs, us per "
              f"call): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

    # the plane-mesh kernel at the staged RK4 run's end state (the model's
    # mesh group, k 8), the staged G1 run's (k 8) and the no-plan run's
    # (k 34), held to its plain version there too; its bytes: the poses of
    # the geoms the group uses, the hulls' vertex rows and the pair tables,
    # each read once, and the slots written once
    for sfx, m, d_end, run in (("", model, d_staged, "staged RK4"),
                               ("_g1", m_g1, d_staged_g1, "staged G1"),
                               ("_wide", m_wide, d_wide,
                                "no-plan staged RK4")):
        gi = next(i for i, p in enumerate(m.mesh_kernel) if p is not None)
        g, mk = m.groups[gi], m.mesh_kernel[gi]
        d_pos = fwd.fwd_position(m, d_end)
        gxp, gxm = d_pos.geom_xpos, d_pos.geom_xmat
        errs["mesh_slots" + sfx] = max(errs["mesh_slots" + sfx],
                                       _mesh_slots_rule(
                                           torch, mk, gxp, gxm,
                                           f"{run} end state")[0])
        tm = lay_tool.mesh_times(torch, hc, kernels, mk, gxp, gxm)
        d_col = coll.collision(m, d_pos)
        act = d_col.contact.dist < d_col.contact.includemargin
        pt = mk.tensors(dev)
        used = len(set(mk.pg1.tolist()) | set(mk.pg2.tolist()))
        moved = (E * used * 12 * 4 + 12 * int(mk.pair_i[:, 1].sum())
                 + nbytes(pt.pair_k, pt.pair_f, pt.tbl16)
                 + E * mk.k * ((21 + hc.META) * 4 + 2 * 8))
        flops = float(_mesh_flops(torch, {"mesh": mk, "offset": g.offset,
                                          "k": mk.k}, d_col, act).sum())
        row("mesh_slots" + sfx, "mesh_slots", run, "plane_mesh.cu",
            "pallas_collision.py:556", tm["wrapper_ms"], tm["plain_ms"],
            moved, flops)
        bound = rows[-1]["bound_ms"]
        print(f"mesh_slots at the {run} end state ({mk.P} pairs, k {mk.k}): "
              f"the wrapper {tm['wrapper_ms']:.4f} ms, the launch alone "
              f"{tm['launch_alone_ms']:.4f} ms (bound {bound:.4f} ms, "
              f"{rows[-1]['bound_by']}: {bound / tm['launch_alone_ms']:.0%} "
              f"of the bound's rate), plain {tm['plain_ms']:.4f} ms; "
              f"active slots {int(act[:, g.offset:g.offset + 3 * mk.k].sum())}"
              f" ({card})")

    # and with the variants' four hull tables at their end state, each
    # env reading its own variant's (the vertex rows of the variants that
    # the envs hold, each read once)
    d_vcol = coll.collision(m_ve, d_v)
    act_v = d_vcol.contact.dist < d_vcol.contact.includemargin
    tm = lay_tool.mesh_times(torch, hc, kernels, mk_v, d_v.geom_xpos,
                             d_v.geom_xmat, env_id=ids_v)
    pt = mk_v.tensors(dev)
    g_v = m_vs.groups[v_grp]
    used = len(set(mk_v.pg1.tolist()) | set(mk_v.pg2.tolist()))
    n_used = len(set(ids_v.tolist()))
    moved = (E * used * 12 * 4 + n_used * 12 * int(mk_v.pair_i[:, 1].sum())
             + nbytes(pt.pair_k) + n_used * (nbytes(pt.pair_f, pt.tbl16)
                                             // mk_v.K)
             + nbytes(ids_v) + E * mk_v.k * ((21 + hc.META) * 4 + 2 * 8))
    flops = float(_mesh_flops(torch, {"mesh": mk_v, "offset": g_v.offset,
                                      "k": mk_v.k}, d_vcol, act_v,
                              env_id=ids_v).sum())
    row("mesh_slots_variants", "mesh_slots", "env variants", "plane_mesh.cu",
        "pallas_collision.py:556", tm["wrapper_ms"], tm["plain_ms"], moved,
        flops)
    bound = rows[-1]["bound_ms"]
    print(f"mesh_slots at the variants end state ({mk_v.K} hull tables, "
          f"{mk_v.P} pairs, k {mk_v.k}): the wrapper {tm['wrapper_ms']:.4f} "
          f"ms, the launch alone {tm['launch_alone_ms']:.4f} ms (bound "
          f"{bound:.4f} ms, {rows[-1]['bound_by']}: "
          f"{bound / tm['launch_alone_ms']:.0%} of the bound's rate), plain "
          f"{tm['plain_ms']:.4f} ms; active slots "
          f"{int(act_v[:, g_v.offset:g_v.offset + 3 * mk_v.k].sum())} "
          f"({card})")

    def newton_row(name, run, operands, options):
        """The Newton kernel's row at these operands."""
        x, force, iters, _ = hn.solve(*operands, **options)
        _, nefc, nv = operands[0].shape
        ms = _time_ms(torch, lambda: hn.solve(*operands, **options))
        plain = _time_ms(torch, lambda: hn.newton_plain(*operands,
                                                        **options),
                         reps=1, warmup=False)
        # per env and Newton step, over its active rows (the kernel reads
        # no inactive row): J x and J dx, the gradient, the Hessian terms,
        # the line search's and the cost's row terms; M products, the
        # Cholesky and its substitutions
        n_act = operands[6].sum(dim=1).double()  # active rows per env
        ls = options["ls_iterations"]
        per_iter = (4 * n_act * nv + 6 * nv * nv
                    + n_act * (2 * nv + nv * (nv + 1))
                    + 2 * nv ** 3 / 3 + (8 * ls + 8) * n_act)
        flops = float((2 * (2 * n_act * nv + 2 * nv * nv + 8 * n_act)
                       + iters.double() * per_iter + 2 * n_act * nv).sum())
        # bytes as the operations: J, aref and D over the active rows, the
        # active flags, R over the equality and friction-loss rows, the
        # friction-loss bounds, M and the vectors; the outputs
        J, M, _, _, R, _, act, asm, ws = operands
        n_fr = options["ne"] + options["nfl"]
        moved = (float(n_act.sum()) * (nv + 2) * J.element_size()
                 + nbytes(M, act, asm, ws, x, force, iters)
                 + (n_fr + options["nfl"]) * R.shape[0] * R.element_size())
        row(name, "newton", run, "newton.cu", "pallas_newton.py:755", ms,
            plain, moved, flops)
        print(f"newton {name} iterations at the timed state ({nefc} rows, "
              f"nv {nv}): mean {float(iters.float().mean()):.2f}, max "
              f"{int(iters.max())}")

    newton_row("newton", "no-plan staged RK4", operands, options)
    # the variants' and the per-env friction loss's rows at their end states
    newton_row("newton_variants", "env variants", ops_v, opts_v)
    newton_row("newton_dr_floss", "env DR friction loss", ops_fl, opts_fl)
    # at width 32, at the end state of G1 with its arms' no-plan path
    d_acc = fwd.fwd_acceleration(m_g1a_wide, fwd.fwd_actuation(
        m_g1a_wide, fwd.fwd_velocity(m_g1a_wide, d_g1a_wide_pos)))
    newton_row("newton_g1arms", "no-plan staged G1 arms",
               *solver.newton_inputs(m_g1a_wide, d_acc, con.make_constraint(
                   m_g1a_wide, d_acc)))

    # the fused kernel at the staged RK4 run's end state (RK4 and Euler),
    # and the mega forward there (FK and collision besides), like for like
    ms_mega = _time_ms(torch, lambda: hm.mega_forward(model, d_staged))
    print(f"mega forward at the staged RK4 end state: {ms_mega:.4f} ms "
          f"per call ({card})")
    for name, key, run in (("rk4", "fused", "staged RK4"),
                           ("euler", "fused_euler", "staged Euler"),
                           ("muscle", "fused_muscle", "staged muscle"),
                           ("a1", "fused_a1", "staged A1"),
                           ("h1", "fused_h1", "staged H1"),
                           ("atlas", "fused_atlas", "staged Atlas"),
                           ("g1", "fused_g1", "staged G1"),
                           ("dr", "fused_dr", "staged env RK4 DR"),
                           ("a1_dr", "fused_a1_dr", "staged env A1 DR"),
                           ("a1pos", "fused_a1pos", "staged A1 position"),
                           ("g1arms", "fused_g1arms", "staged G1 arms"),
                           ("h1arms", "fused_h1arms", "staged H1 arms"),
                           ("atlasarms", "fused_atlasarms",
                            "staged Atlas arms"),
                           ("atlasarms_dr", "fused_atlasarms_dr",
                            "staged env Atlas arms DR"),
                           ("g1arms_dr", "fused_g1arms_dr",
                            "staged env G1 arms DR"),
                           ("talos", "fused_talos", "staged Talos"),
                           ("dr_leaves", "fused_dr_leaves",
                            "env DR leaves")):
        m, d = models[name], fused_in[name]
        k = hf.fused_constraint(m, d)
        vec, pack = hf.vec(m, d), hf.contact_pack(m, d)
        out_bytes = nbytes(k.qacc, k.qacc_smooth, k.qfrc_constraint,
                           k.solver_niter, k.solver_taken) \
            + E * m.plan.nrows * 4 \
            + (nbytes(k.euler_dv) if m.plan.euler_dv else 0)
        flops = float(_forward_flops(
            torch, m, d, k.solver_niter, in_kernel_collision=False,
            qacc=k.qacc).sum())
        ms = _time_ms(torch, lambda: hf.fused_constraint(m, d))
        plain = _time_ms(torch, lambda: hf.fused_constraint_plain(
            m, d, solve64=m.plan.elliptic), reps=1, warmup=False)
        row(key, "fused", run, "fused.cu", "pallas_constraint.py:2052", ms,
            plain, nbytes(*m.plan.tables(dev), vec, pack) + out_bytes, flops)

    # the mega path's kernels at the main paths' end states
    def mega_bounds(m, S_, sflops):
        """Bound ms of one mega forward at S_ and of the megastep's control
        step whose forwards did `sflops`."""
        pt = m.plan.tables(dev)
        ins = (S_.qpos, S_.qvel, S_.act, S_.ctrl, S_.qfrc_applied,
               S_.xfrc_applied, S_.qacc_warmstart) + (
            () if S_.dof_damping is None else (S_.dof_damping,))
        k = fwd.forward(m, S_)
        out_bytes = nbytes(k.qacc, k.qacc_smooth, k.qfrc_constraint,
                           k.contact.dist, k.solver_niter, k.solver_taken) \
            + E * 4 * (m.plan.ncon * (2 if m.plan.mega_ell else 1)
                       + sum(m.plan.rows_per)) \
            + (nbytes(k.euler_dv) if m.plan.euler_dv else 0) \
            + (nbytes(k.act_dot) if m.na else 0)
        flops = float(_forward_flops(torch, m, fwd.forward_staged(
            m, S_, plain=True), k.solver_niter).sum())
        return ((nbytes(*pt, *ins) + out_bytes, flops),
                (nbytes(*pt, *ins) + 3 * nbytes(S_.qvel) + nbytes(S_.act),
                 float(torch.stack(sflops).sum())))

    for m, S_, S1_, sflops, sfx, run in (
            (model, S, S1, step_flops, "", "main RK4"),
            (m_eu, S_eu, S1_eu, step_flops_eu, "_euler", "main Euler"),
            (m_mu, S_mu, S1_mu, step_flops_mu, "_muscle", "main muscle"),
            (m_a1, S_a1, S1_a1, step_flops_a1, "_a1", "main A1"),
            (m_h1, S_h1, *biped_runs["h1"], "_h1", "main H1"),
            (m_at, S_at, *biped_runs["atlas"], "_atlas", "main Atlas"),
            (m_g1, S_g1, S1_g1, step_flops_g1, "_g1", "main G1"),
            (m_dr, S_dr, S1_dr, step_flops_dr, "_dr", "env RK4 DR"),
            (m_a1p, S_a1p_env, S1_a1p, step_flops_a1p, "_a1pos",
             "main A1 position"),
            (m_g1a, S_g1a, S1_g1a, step_flops_g1a, "_g1arms",
             "main G1 arms"),
            (m_h1a, S_h1a, *arms_runs["h1arms"], "_h1arms", "main H1 arms"),
            (m_ata, S_ata, *arms_runs["atlasarms"], "_atlasarms",
             "main Atlas arms"),
            (m_ata_dr, S_atadr, S1_atadr, step_flops_atadr, "_atlasarms_dr",
             "env Atlas arms DR"),
            (m_ta, S_ta, *kp_runs["talos"], "_talos", "main Talos"),
            (m_g1k, S_g1k, *kp_runs["g1kp"], "_g1kp", "main G1 k=P")):
        b_fwd, b_step = mega_bounds(m, S_, sflops)
        ms = _time_ms(torch, lambda: hm.mega_forward(m, S_))
        plain = _time_ms(torch, lambda: hm.mega_forward_plain(m, S_), reps=1,
                         warmup=False)
        row("mega_forward" + sfx, "mega_forward", run, "mega.cu",
            "pallas_constraint.py:2335", ms, plain, *b_fwd)
        ms = _time_ms(torch, lambda: hm.mega_step_n(m, S1_, SUBSTEPS), reps=3)
        plain = _time_ms(torch, lambda: hm.mega_step_n_plain(m, S1_, SUBSTEPS),
                         reps=1, warmup=False)
        row("megastep" + sfx, "megastep", run, "mega.cu",
            "pallas_constraint.py:2800", ms, plain, *b_step)
    # the mega forward's extended instance with the damping rows (A1's DR
    # env: no megastep)
    b_fwd, _ = mega_bounds(m_a1_dr, S_a1dr, [torch.zeros(E, device=dev)])
    ms = _time_ms(torch, lambda: hm.mega_forward(m_a1_dr, S_a1dr))
    plain = _time_ms(torch, lambda: hm.mega_forward_plain(m_a1_dr, S_a1dr),
                     reps=1, warmup=False)
    row("mega_forward_a1_dr", "mega_forward", "env A1 DR", "mega.cu",
        "pallas_constraint.py:2335", ms, plain, *b_fwd)
    # and the extended pyramidal instance with the rows (G1's DR env)
    b_fwd, _ = mega_bounds(m_g1_dr, S_g1dr, [torch.zeros(E, device=dev)])
    ms = _time_ms(torch, lambda: hm.mega_forward(m_g1_dr, S_g1dr))
    plain = _time_ms(torch, lambda: hm.mega_forward_plain(m_g1_dr, S_g1dr),
                     reps=1, warmup=False)
    row("mega_forward_g1_dr", "mega_forward", "env G1 DR", "mega.cu",
        "pallas_constraint.py:2335", ms, plain, *b_fwd)
    # and at width 32 (G1 with its arms' DR env)
    b_fwd, _ = mega_bounds(m_g1a_dr, S_g1adr, [torch.zeros(E, device=dev)])
    ms = _time_ms(torch, lambda: hm.mega_forward(m_g1a_dr, S_g1adr))
    plain = _time_ms(torch, lambda: hm.mega_forward_plain(m_g1a_dr, S_g1adr),
                     reps=1, warmup=False)
    row("mega_forward_g1arms_dr", "mega_forward", "env G1 arms DR", "mega.cu",
        "pallas_constraint.py:2335", ms, plain, *b_fwd)
    # the muscle kernels again in deep contact (after the first control step)
    b_fwd, b_step = mega_bounds(m_mu, S_mu_c, step_flops_mu_c)
    ms_fc = _time_ms(torch, lambda: hm.mega_forward(m_mu, S_mu_c))
    ms_sc = _time_ms(torch, lambda: hm.mega_step_n(m_mu, S1_mu_c, SUBSTEPS),
                     reps=3)
    print(f"muscle kernels in contact ({n_con_c / E:.2f} contacts per env): "
          f"mega forward {ms_fc:.4f} ms (bound {_bound(*b_fwd)[0]:.4f} ms), "
          f"megastep {ms_sc:.4f} ms per control step (bound "
          f"{_bound(*b_step)[0]:.4f} ms) ({card})")

    for r in rows:
        print(f"  {r['name']:18s} {r['ms']:9.4f} ms  plain {r['plain_ms']:9.4f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches {r['launches']}")
    print(f"env layer (step_batch) {env_rate:.0f} env-steps/s RK4 (step_n "
          f"alone {raw:.0f}), {env_dr_rate:.0f} RK4 with damping DR (step_n "
          f"alone {raw_dr:.0f}), {env_a1dr_rate:.0f} A1 with damping DR; "
          f"staged {staged_dr_rate:.0f} RK4 DR, {staged_a1dr_rate:.0f} A1 DR; "
          f"G1 {env_g1_rate:.0f} (step_n alone {raw_g1:.0f}), G1 with damping "
          f"DR {env_g1dr_rate:.0f}; A1 position {env_a1p_rate:.0f} (step_n "
          f"alone {raw_a1p:.0f}); "
          f"card: {card}")
    print(f"A1 position (a1pos): main path {env_steps_a1p:.0f} env-steps/s, "
          f"staged path {staged_a1p_rate:.0f}, megastep "
          f"{next(r['ms'] for r in rows if r['name'] == 'megastep_a1pos'):.3f}"
          f" ms per control step, step_batch {env_a1p_rate:.0f} against "
          f"step_n alone {raw_a1p:.0f}; card: {card}")
    print(f"G1 with arms (g1arms, width 32): main path {env_steps_g1a:.0f} "
          f"env-steps/s, staged path {staged_g1a_rate:.0f} "
          f"({staged_g1a_ops or 'not measured'} kernels per forward), "
          f"no-plan staged path {g1a_wide_rate:.0f} (the Newton kernel at "
          f"width 32), megastep "
          f"{next(r['ms'] for r in rows if r['name'] == 'megastep_g1arms'):.3f}"
          f" ms per control step, step_batch {env_g1a_rate:.0f} against "
          f"step_n alone {raw_g1a:.0f}; card: {card}")
    ms_of = {r["name"]: r["ms"] for r in rows}
    print(f"H1 with arms (h1arms, width 32): main path {env_steps_h1a:.0f} "
          f"env-steps/s, staged path {staged_h1a_rate:.0f}, megastep "
          f"{ms_of['megastep_h1arms']:.3f} ms per control step, mega forward "
          f"{ms_of['mega_forward_h1arms']:.3f} ms, fused "
          f"{ms_of['fused_h1arms']:.3f} ms, step_batch {env_h1a_rate:.0f} "
          f"against step_n alone {raw_h1a:.0f}; Atlas with arms (atlasarms, "
          f"width 32): main path {env_steps_ata:.0f} env-steps/s, staged "
          f"path {staged_ata_rate:.0f}, megastep "
          f"{ms_of['megastep_atlasarms']:.3f} ms per control step, mega "
          f"forward {ms_of['mega_forward_atlasarms']:.3f} ms, fused "
          f"{ms_of['fused_atlasarms']:.3f} ms, with damping DR: step_batch "
          f"{env_atadr_rate:.0f} against step_n alone {raw_atadr:.0f}, "
          f"megastep {ms_of['megastep_atlasarms_dr']:.3f} ms; G1 with arms "
          f"with damping DR {env_g1adr_rate:.0f} env-steps/s (mega forward "
          f"{ms_of['mega_forward_g1arms_dr']:.3f} ms); card: {card}")
    print(f"Talos (talos; its plane-mesh group at k = P ranked): main path "
          f"{env_steps_ta:.0f} env-steps/s, staged path {staged_ta_rate:.0f} "
          f"({staged_ta_ops or 'not measured'} kernels per forward), megastep "
          f"{ms_of['megastep_talos']:.3f} ms per control step, mega forward "
          f"{ms_of['mega_forward_talos']:.3f} ms, fused "
          f"{ms_of['fused_talos']:.3f} ms, step_batch {env_ta_rate:.0f} "
          f"against step_n alone {raw_ta:.0f} (medians of {PAIRINGS}); G1 at "
          f"k = P (g1kp): main path {env_steps_g1k:.0f} env-steps/s, megastep "
          f"{ms_of['megastep_g1kp']:.3f} ms, mega forward "
          f"{ms_of['mega_forward_g1kp']:.3f} ms; card: {card}")
    print(f"main path {env_steps:.0f} env-steps/s RK4, {env_steps_eu:.0f} "
          f"Euler, {env_steps_mu:.0f} muscle Euler, {env_steps_a1:.0f} A1, "
          f"{env_steps_h1:.0f} H1, {env_steps_at:.0f} Atlas, "
          f"{env_steps_g1:.0f} G1, {env_steps_a1p:.0f} A1 position; "
          f"staged path "
          f"{staged_rate:.0f} env-steps/s RK4, {staged_eu_rate:.0f} Euler, "
          f"{staged_mu_rate:.0f} muscle, {staged_a1_rate:.0f} A1, "
          f"{staged_h1_rate:.0f} H1, {staged_at_rate:.0f} Atlas, "
          f"{staged_g1_rate:.0f} G1, {staged_a1p_rate:.0f} A1 position "
          f"({staged_g1_ops or 'not measured'} "
          f"kernels per G1 forward) "
          f"({staged_a1_ops or 'not measured'} kernels per A1 forward; "
          f"{staged_ops or 'not measured'} "
          f"kernels per forward), no-plan staged path {wide_rate:.0f} "
          f"({wide_ops or 'not measured'} per forward); card: {card}")
    phase("end")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
