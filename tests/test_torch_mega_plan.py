"""The port's mega plan (`ops/plan.py`) against the JAX package's
`RowPlan` / `FkPlan` / `ColPlan` on both fixtures, with no kernel run.

The JAX plan is built as its forward builds it (`pallas_constraint.
get_plan` on contacts from one collision pass), with `LMT_MESH_VCAP` at the
fixture's vertex-table width. Exact: row counts and layout, groups, pair
gids and bodies, slot order, the tree and FK tables; floats as float64.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import plan as tplan
from test_torch_fixture import ASSET, export_model, jax_model

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(params=[True, False], ids=["full", "small"])
def plans(request, monkeypatch):
    full = request.param
    jm = jax_model(full)
    leaves, aux = export_model(jm)
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    monkeypatch.setenv("LMT_MESH_VCAP", str(tm.mesh_vert.shape[1]))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    d = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
    with jax.enable_x64(False):
        jp = pc.get_plan(jm, d.contact)
    assert jp is not None and jp.mega and jp.smooth and jp.uniform
    assert tm.plan is not None and tm.plan.mega
    return jp, tm.plan


def test_rows_match(plans):
    jp, tp = plans
    for name in ("nrows", "ne", "nfl", "nl", "npad", "ncon", "nv", "nq"):
        assert getattr(tp, name) == getattr(jp, name), name
    np.testing.assert_array_equal(tp.con_efcadr, jp.con_efcadr)
    np.testing.assert_array_equal(tp.con_dim, jp.con_dim)
    for kind in ("eq", "fl", "lim"):
        got, ref = getattr(tp, kind), getattr(jp, kind)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            for k in r:
                np.testing.assert_allclose(g[k], r[k], rtol=1e-15,
                                           err_msg=f"{kind}.{k}")


def test_groups_and_slot_order_match(plans):
    jp, tp = plans
    jg, tg = jp.colp.groups, tp.groups
    assert [(g["kind"], g["k"], g["slots"]) for g in tg] == \
        [(g["kind"], g["k"], g["slots"]) for g in jg]
    offsets = np.cumsum([0] + [g["k"] * g["slots"] for g in jg])[:-1]
    assert [g["offset"] for g in tg] == offsets.tolist()
    for a, b in zip(tg, jg):
        assert [(p["gid"], p["body"]) for p in a["pairs"]] == \
            [(p["gid"], p["body"]) for p in b["pairs"]]
        for p, q in zip(a["pairs"], b["pairs"]):
            for k in ("gpos", "gquat", "size"):
                if k in q:
                    np.testing.assert_array_equal(p[k], q[k])
        assert a["margin"] == b["margin"]
    assert tp.plane_gid == jp.colp.plane_gid
    np.testing.assert_allclose(tp.n, jp.colp.n, rtol=0, atol=1e-15)
    assert tp.pp == jp.colp.pp


def test_contact_statics_match(plans):
    jp, tp = plans
    np.testing.assert_allclose(tp.c_frame, jp.c_frame, rtol=0, atol=1e-15)
    for name in ("c_margin", "c_solref", "c_solimp", "c_fric", "c_fric5"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert jp.fric_uniform  # the port's plan requires it


def test_tree_and_fk_tables_match(plans):
    jp, tp = plans
    assert tp.topo_rev == jp.topo_rev
    assert tp.dof_bodyid == jp.dof_bodyid
    np.testing.assert_array_equal(tp.anc, jp.anc)
    np.testing.assert_array_equal(tp.dofmask, jp.dofmask.astype(bool))
    assert tp.body_parent == jp.body_parent
    assert tp.body_iw == jp.body_iw
    fk = jp.fkp
    assert tp.topo == fk.topo
    for name in ("body_pos", "body_quat", "body_ipos", "body_iquat",
                 "body_joints"):
        assert getattr(tp, name) == getattr(fk, name), name
    assert tp.sm_gravity == jp.sm_gravity


def test_float64_data_gets_no_plan():
    """maybe_plan refuses float64 data, as the reference's does: the
    forward takes the staged path."""
    m = tio.load_model_npz(ASSET, device="cpu", dtype=torch.float64)
    assert m.plan is not None
    d = tio.make_data(m, 2)
    assert tplan.maybe_plan(m, d) is None
    assert fwd.step_n(m, d, 2) is None
    m32 = tio.load_model_npz(ASSET, device="cpu")
    assert tplan.maybe_plan(m32, tio.make_data(m32, 2)) is m32.plan


@pytest.mark.parametrize("change", [
    {"opt.iterations": 20},
    {"opt.ls_iterations": 9},
    {"leaf:pair_margin": 0.01},
    {"leaf:pair_solref": 0.03},
    {"contact_k_plane": 100},
])
def test_outside_the_envelope_gets_no_plan(change):
    """Models the reference gives no mega plan load with none, and keep
    the staged path: a solver budget past the batched fast path (no plan
    at all), non-uniform pair statics (a row plan for the fused kernel,
    with the generic contact pack, but no mega), a mesh group with k >= P
    (no plane-mesh kernel plan; its 233 slots also put the rows past
    ROWS_MAX, so no plan at all)."""
    leaves, aux = tio.read_model_npz(ASSET)
    for k, v in change.items():
        if k.startswith("leaf:"):
            arr = leaves[k[5:]].copy()
            arr[-1] = v  # the last pair only
            leaves[k[5:]] = arr
        else:
            aux[k] = v
    m = tio.model_from_numpy(leaves, aux, device="cpu")
    assert m.plan is None or not m.plan.mega
    if "leaf:pair_margin" in change or "leaf:pair_solref" in change:
        assert m.plan is not None and m.plan.pack_w == 26
    else:
        assert m.plan is None


def test_header_matches_kernel_source():
    """csrc/mega.cu and csrc/fused.cu read the packed tables through
    forward_core.cuh's `enum Header`, which must list ops/plan.py's HEADER
    in order; the packed widths hold."""
    src = (REPO / "loco_mujoco_tpu_torch/csrc/forward_core.cuh").read_text()
    body = re.search(r"enum Header \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",")
             if n.strip()]
    assert tuple(names) == tplan.HEADER
    m = tio.load_model_npz(ASSET, device="cpu")
    ints, flts = m.plan.pack()
    hdr = ints[:len(tplan.HEADER)]
    assert hdr[tplan.H["NROWS"]] == m.plan.nrows == 144
    assert hdr[tplan.H["NCON"]] == m.ncon == 32
    assert flts.nbytes < 2.1e6  # the 75 hull tables, 1.97 MB
