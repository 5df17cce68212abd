"""The Talos-shaped stand-in (`test_torch_talos_fixture`) on the mega path:
the plane-only collision with a plane-box group and a plane-mesh group at
k = P, which the mega kernels rank, deepest first, as the reference's
mega kernels do (tests/test_torch_kp_mega.py holds the extended instance
at k = P and has the helpers).

- The port's forward on the mega path (float32, on the CPU: the plain
  version of the mega kernel's plane-only instance) against the JAX
  package's mega kernel (`pallas_constraint._mega_batched` with
  `collide_env_block` and `_mesh_group_slots`), in interpret mode,
  compiled once, on the small variant, 8 envs of `talos_states`, at
  tests/test_mega.py's tolerances (qacc, qfrc_constraint and
  efc_force_contact rel 5e-4; active slots equal, geom1 and geom2 exact on
  them, depths atol 1e-5); the same forward with its plane-mesh slots in
  the staged path's order parts from the reference on these states.
- The float64 staged forward: tests/test_torch_kp_f64.py.
"""

import numpy as np
import pytest

import test_torch_talos_fixture as talos_fix
from test_torch_kp_mega import (check_contacts, check_fields, check_kp_group,
                                mega_outputs)


@pytest.fixture(scope="module")
def outputs():
    return mega_outputs(talos_fix.talos_mega_states, in_order=True)


def test_talos_mega_takes_the_plane_only_path(outputs):
    """The plane-only plan (the kernels' instance 0) with its plane-box
    group and its plane-mesh group at k = P; both feet in contact in some
    env; the in-order layout parts from the reference on these states."""
    tm, ref, got, flat = outputs
    plan = tm.plan
    assert plan.mega and not plan.mega_ell and plan.euler_dv
    assert [d["kind"] for d in plan.groups] == ["box", "mesh"]
    check_kp_group(tm, ref, got, flat, pairs=2)
    geom = tm.names["geom"]
    g2 = ref.contact.geom2
    on = ref.contact.dist < ref.contact.includemargin
    feet = [np.any(on & (g2 == geom[f"{s}_foot"]), axis=1)
            for s in ("right", "left")]
    assert np.any(feet[0] & feet[1])
    assert bool((got.contact.geom1 == plan.plane_gid).all())


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_talos_mega_forward_matches_jax_mega_kernel(outputs, field):
    tm, ref, got, _ = outputs
    check_fields(got, ref, field)


def test_talos_mega_contacts_match_jax(outputs):
    tm, ref, got, _ = outputs
    check_contacts(got, ref)

