"""On the card, at each closed cell's own size: one seed's run, the
program's readings under the configuration's limits and the control's (the
reference in fp8 at the same positions) above one of them. Skips without
a card; run there with ``python -m pytest faasbench -m card``."""
import time

import pytest

from control import readings
from harness.manifest import Manifest
from harness.measure import GAPS
from test_faasbench_manifest import ROOT

MAN = Manifest(ROOT)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN.bench["workloads"]
                                  if w["traffic"] == "closed"])
def test_control_fails_where_the_program_passes(card, cell):
    import run

    run.set_env()
    limits = MAN.config(MAN.cell(cell)["config"])["limits"]
    r = readings(MAN, cell, 2 ** 31 + 7, 8.0, time.perf_counter())
    assert r["program"]["tokens"] > 0
    assert all(r["program"][k] <= limits[k] for k in GAPS), r
    assert any(r["control"][k] > limits[k] for k in GAPS), r
