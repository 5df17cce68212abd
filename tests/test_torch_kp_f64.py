"""The float64 staged forward of the stand-ins whose plane-mesh group is at
k = P (the Talos-shaped fixture and the G1-shaped one at plane budget 10,
small sizes) against the JAX package's XLA path: qacc and the constraint
forces at rel 1e-7 (test_torch_forward.py's tolerance), and every slot's
geoms in the XLA path's order, the plane-mesh group's pairs in bucket
order (the reference's staged path keeps them in order at k = P,
`collision.py:397-410`; its mega kernels rank them,
tests/test_torch_kp_mega.py). Float64 data has no plan: the port's
collision, its plane-mesh group by the XLA port, make_constraint and the
Newton solve.
"""

import test_torch_g1_fixture as g1_fix
import test_torch_talos_fixture as talos_fix
from test_torch_kp_mega import check_staged_f64, staged_f64


def test_talos_staged_float64_matches_xla():
    check_staged_f64(*staged_f64(lambda: talos_fix.torch_model(full=False),
                                 talos_fix.talos_states))


def test_kp_staged_float64_matches_xla():
    check_staged_f64(*staged_f64(
        lambda: g1_fix.torch_model(full=False, k_plane=g1_fix.K_PLANE_KP),
        g1_fix.g1_states))
