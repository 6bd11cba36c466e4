"""Whole solves with the line and the polygon footprint against all four
slot families, moving, on the CPU: the cases of
``tests/test_torch_footprints_lp_solves.py`` (which holds their setup and
tolerances) that ``tests/test_fused_solver.py`` draws with
``_widened_setup``: a line footprint (key 37: a point, two circle, two line
and a polygon slot) and a polygon footprint (key 53: one slot of each
family), dynamic obstacles on; the un-fused ``solve`` and
``fused_solve_plain`` against JAX ``vmap(solve_single)`` in float64 and
float32.
"""

import pytest

from test_torch_footprints_lp_solves import CASES, HERE, check_solve

MIXED = tuple(case for case in CASES if case not in HERE)


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", MIXED)
def test_torch_footprint_mixed_dynamic_solve_matches_jax(case, dtype_name, path):
    check_solve(case, dtype_name, path)
