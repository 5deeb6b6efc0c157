"""The control comes out not correct: the plain reference one precision
below the configuration's (or with its stated matching rule broken) in the
program's place, judged against each cell's limits, at a size the CPU runs.
On the card the same readings come from ``sfmbench/control.py`` at the
cells' own sizes."""

import pytest
import torch

from sfmbench import control, harness, run
from sfmbench_tiny import tiny_copy


@pytest.mark.parametrize("workload", ["orbit512_dog.batch", "orbit512_dog.stream"])
def test_the_control_fails_and_the_program_passes(tmp_path, workload):
    here = tiny_copy(tmp_path)
    rows = control.readings(workload, [11, 12], device=torch.device("cpu"), here=here,
                            emit=lambda line: None)
    limits = harness.cell(workload, here=here)["limits"]
    for row in rows:
        prog = {k: {"value": row["program"][k], "limit": v} for k, v in limits.items()}
        ctl = {k: {"value": row["control"][k], "limit": v} for k, v in limits.items()}
        assert run.passes(prog), row["program"]
        assert not run.passes(ctl), row["control"]
