"""The manifest and the files it names: every cell's configuration, mix,
reference and metric readers are found by name, the manifest keeps the
benchmark's schema, and a new cell, mix, configuration and metric need new
files and entries only."""
import hashlib
import json
import os
import re
import shutil

import pytest

from harness.manifest import Manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return Manifest(ROOT)


def test_shape(man):
    b = man.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["faasbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) \
        == len(b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in Manifest(
    ROOT).bench["workloads"]])
def test_cell_files_found(man, cell):
    w = man.cell(cell)
    spec = man.config(w["config"])
    mix = man.traffic(w["traffic"])
    ref = man.reference(spec)
    assert callable(ref.forward) and callable(ref.draw_weights)
    assert mix["fanout"] <= mix["slots"]
    e2e = man.metrics(cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = man.metrics(cell, "per_layer")
    assert layer
    reported = {m["name"] for m in e2e}
    for m in e2e + layer:
        assert callable(man.reader(m["name"]))
    for m in layer:        # each moves an end-to-end metric the cell reports
        assert m["moves"] in reported


def test_configs_unreduced(man):
    for c in man.bench["configs"]:
        assert c["reduced"] == []
        assert c["file"].startswith("faasbench/configs/")
        assert man.config(c["name"])["source"] == c["source"]


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_cell_mix_config_metric_by_files_only(tmp_path):
    """A cell on a new configuration and a new mix, with a new per-layer
    metric, added as files and manifest entries: no file that was there
    changes, and the harness finds all of it by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "faasbench"), root / "faasbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "faasbench")
    fb = root / "faasbench"
    spec = json.loads((fb / "configs" / "smollm-360m.json").read_text())
    spec.update(name="dummy-lm", num_hidden_layers=2)
    (fb / "configs" / "dummy-lm.json").write_text(json.dumps(spec))
    mix = json.loads((fb / "traffic" / "closed.json").read_text())
    mix.update(fanout=8, slots=8)
    (fb / "traffic" / "closed8.json").write_text(json.dumps(mix))
    (fb / "metrics" / "slots_per_step.py").write_text(
        "def read(rec):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-lm", "source": "x",
                             "file": "faasbench/configs/dummy-lm.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "dummy-lm.closed8",
                               "config": "dummy-lm", "traffic": "closed8",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("dummy-lm.closed8")
    bench["per_layer"].append({"name": "slots_per_step", "unit": "slots",
                               "better": "higher", "source": "program_span",
                               "layer": "batcher and replica",
                               "moves": "tokens_per_s",
                               "workloads": ["dummy-lm.closed8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(fb)
    assert all(after[k] == v for k, v in before.items())
    man = Manifest(str(root))
    w = man.cell("dummy-lm.closed8")
    assert man.config(w["config"])["num_hidden_layers"] == 2
    assert man.traffic(w["traffic"])["slots"] == 8
    assert [m["name"] for m in man.metrics(w["name"], "per_layer")] == [
        "slots_per_step"]
    assert man.reader("slots_per_step")(None) == 42.0
    assert {m["name"] for m in man.metrics(w["name"], "end_to_end")} == {
        "tokens_per_s", "setup_s"}
