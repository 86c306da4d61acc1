"""The control fails: the reference computed in bfloat16, put in the
program's place, is not correct under the cells' limits, while the
program's own run at the same size is."""
import pytest

from mpcbench import compare
from mpcbench.control import control_gaps

from . import tiny


@pytest.mark.parametrize("name", ["fig8_b64_n64.loop", "fig8_b64_n64.ctl100hz"])
def test_the_control_is_not_correct(name):
    c = tiny.cell(name)
    run = tiny.run(c)
    assert compare.within(run.gaps, c.limits), run.gaps
    gaps = control_gaps(c, run, 2)
    assert not compare.within(gaps, c.limits), gaps
