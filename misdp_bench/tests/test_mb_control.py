"""The control of each cell's check: the plain reference in float32 put in
the program's place on a window's answers comes out not correct, at the
cells' own sizes, while the program's own answers pass."""

import pytest

from misdp_bench.control import control_checks
from misdp_bench.tests.conftest import cells

# the number of each cell whose limit was set from the two readings
SET_FROM_READINGS = {"bound_gap_median", "node_bound_gap_median"}


@pytest.mark.parametrize("entry", [c for c, _ in cells()],
                         ids=lambda c: c["name"])
@pytest.mark.parametrize("seed", [1, 2**31 + 11, 987654321])
def test_control_is_not_correct(entry, seed):
    got = control_checks(entry, seed)
    assert got["program"]["correct"] is True
    assert got["control"]["correct"] is False
    assert got["control"]["attempted"] == got["program"]["attempted"] > 0
    failing = {k for k, c in got["control"]["checks"].items()
               if c["value"] > c["limit"]}
    assert failing & SET_FROM_READINGS
