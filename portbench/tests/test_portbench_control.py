"""On the card: each cell's control (the plain reference in the precision
below the configuration's, put in the program's place) fails the cell's
check at the cell's own size, on three seeds.  ``calibrate.py`` makes the
same readings for the limits."""

import pytest

from portbench import calibrate
from portbench.harness import checks

from .cells import cell, listed

CELLS = listed()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name, seed, cuda):
    c = cell(cell_name)
    r = calibrate.readings(c, seed, cuda, control=True)
    lim = c.traffic["limits"]
    assert not checks.all_within(
        [checks.number(k, r[k], lim[k]) for k in lim]), r
