"""The check's control: the reference computed in fp8, the precision below
the configuration's bf16, has to come out not correct. On the card, at a
cell's own size (``card``: skipped without one), it fails the cell's limits
where the program passes them; at a small size on the CPU it reads well
above the program. The control's numbers are the check's own
(``check.numbers``), at the one position a request returns."""
import json

import pytest
import torch

from conftest import ROOT
from portbench.harness import check as CK
from portbench.harness.calib import readings
from portbench.harness.layout import Layout

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 6007


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limits_on_the_card(card, name):
    layout = Layout(ROOT)
    cell = layout.cell(name)
    seconds = 8.0 if cell.mix["kind"] == "open" else 1.0
    out = readings(layout, name, SEED, seconds, card, control=True)
    limits = cell.spec["check"]["limits"]
    assert CK.judge(out["program"], limits)[0]
    assert not CK.judge(out["reference_fp8"], limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_well_above_the_program_at_a_small_size(smoke_root, name):
    out = readings(Layout(smoke_root), name, SEED, 2.0, torch.device("cpu"), control=True)
    ctrl, prog = out["reference_fp8"], out["program"]
    assert set(ctrl) == set(prog) == set(Layout(smoke_root).cell(name).spec["check"]["limits"])
    assert ctrl["logit_err"] >= 3 * prog["logit_err"]
