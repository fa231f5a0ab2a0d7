"""The control of the check, on the card: the program with its matmuls in
bfloat16, below the float32 that the port states, must fail the check
where the program passes it. The readings at each cell's size come from
`python3 perfbench/control.py`; this keeps the smallest cell's, with a
short window."""
import pytest

import control


@pytest.mark.card
def test_the_control_fails_the_check_and_the_program_passes(card):
    out = control.readings("cif_qp37_live", [5, 6, 7], 3.0, ["bf16"],
                           program=True)
    prog = [r for _, what, r in out if what == "program"]
    ctl = [r for _, what, r in out if what.startswith("control")]
    assert len(prog) == len(ctl) == 3
    assert all(r["correct"] for r in prog)
    assert not any(r["correct"] for r in ctl)
