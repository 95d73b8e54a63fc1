"""The manifest and the files it names: every cell's configuration, mix,
reference and metric readers are found by name, the manifest keeps the
benchmark's schema, a configuration's cut is written down, and a new cell,
mix, configuration and metric need new files and entries only, also for a
family the program's ``ArchConfig`` cannot describe."""
import hashlib
import json
import os
import re
import shutil
import sys

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


def cut_written_down(entry: dict, spec: dict) -> list:
    """What a configuration's cut leaves unsaid: each key of ``reduced`` is
    a key of its file, whose ``published`` object gives that key's published
    value, and a cut file states its ``deployment``: ``chips_per_layer``,
    how many chips share each layer (the model-configs guide, section 4)."""
    faults = []
    published = spec.get("published", {})
    for key in entry["reduced"]:
        if key not in spec:
            faults.append(f"{key}: not a key of the file")
        if key not in published:
            faults.append(f"{key}: no published value")
    chips = spec.get("deployment", {}).get("chips_per_layer")
    if entry["reduced"] and not (isinstance(chips, int) and chips >= 1):
        faults.append("deployment: chips_per_layer not stated")
    return faults


def test_configs_unreduced(man):
    """Each configuration is its source's at the published sizes, or its
    file writes the cut down."""
    for c in man.bench["configs"]:
        assert c["file"].startswith("faasbench/configs/")
        spec = man.config(c["name"])
        assert spec["source"] == c["source"]
        assert cut_written_down(c, spec) == [], c["name"]


CUT = {"n_routed_experts": 8, "vocab_size": 12800,
       "published": {"n_routed_experts": 64, "vocab_size": 102400},
       "deployment": {"chips_per_layer": 8}}


@pytest.mark.parametrize("case,drop,faults", [
    ("written", None, []),
    ("not_in_file", "n_routed_experts", ["n_routed_experts: not a key of "
                                         "the file"]),
    ("unpublished", "published", ["n_routed_experts: no published value",
                                  "vocab_size: no published value"]),
    ("no_deployment", "deployment", ["deployment: chips_per_layer not "
                                     "stated"])])
def test_a_cut_is_written_down(case, drop, faults):
    spec = {k: v for k, v in CUT.items() if k != drop}
    entry = {"reduced": ["n_routed_experts", "vocab_size"]}
    assert cut_written_down(entry, spec) == faults


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


LATENT_REF = """\"\"\"A family the program's ArchConfig cannot describe.\"\"\"
from __future__ import annotations

FAMILY = "mla"


def arch_kwargs(spec):
    return dict(program_config="repro_torch.models.api:LatentConfig",
                n_layers=spec["num_hidden_layers"],
                kv_lora_rank=spec["kv_lora_rank"])


def token_flops(spec, positions):
    return 2.0 * spec["hidden_size"] ** 2 + 1e3 * positions
"""
LATENT_ROOFLINE = """from harness import costs
from harness.readers import kernel_time


def read(rec):
    seconds, launches = kernel_time(rec, "mla_decode_kernel")
    if not launches:
        return None
    least = costs.bound(1e6 * launches, 0.0, rec.spec["torch_dtype"])
    return 100.0 * least["bound_ms"] / (1e3 * seconds)
"""


def test_new_cell_mix_config_metric_by_files_only(tmp_path, monkeypatch):
    """Cells on new configurations and a new mix, with new per-layer
    metrics, added as files and manifest entries: no file that was there
    changes, and the harness finds all of it by name. One configuration is
    cut, and its family needs a program config of its own, an operation
    count of its own and a kernel that is not K1."""
    import reference
    from test_faasbench_reference import _imports

    from harness import readers
    from harness.cell import Record, build_program_cfg

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "faasbench"), root / "faasbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "faasbench")
    fb = root / "faasbench"
    spec = json.loads((fb / "configs" / "smollm-360m.json").read_text())
    spec.update(name="dummy-lm", num_hidden_layers=2)
    (fb / "configs" / "dummy-lm.json").write_text(json.dumps(spec))
    latent = dict(name="dummy-mla", source="y", reference="dummy_mla",
                  num_hidden_layers=27, hidden_size=2048, kv_lora_rank=512,
                  n_routed_experts=8, torch_dtype="bfloat16",
                  published={"n_routed_experts": 64},
                  deployment={"chips_per_layer": 8})
    (fb / "configs" / "dummy-mla.json").write_text(json.dumps(latent))
    (fb / "reference" / "dummy_mla.py").write_text(LATENT_REF)
    mix = json.loads((fb / "traffic" / "closed.json").read_text())
    mix.update(fanout=8, slots=8)
    (fb / "traffic" / "closed8.json").write_text(json.dumps(mix))
    (fb / "metrics" / "slots_per_step.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (fb / "metrics" / "mla_decode_roofline.py").write_text(LATENT_ROOFLINE)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": "dummy-lm", "source": "x",
         "file": "faasbench/configs/dummy-lm.json",
         "reduced": ["num_hidden_layers"], "why": "x"},
        {"name": "dummy-mla", "source": "y",
         "file": "faasbench/configs/dummy-mla.json",
         "reduced": ["n_routed_experts"], "why": "y"}]
    bench["workloads"] += [
        {"name": "dummy-lm.closed8", "config": "dummy-lm",
         "traffic": "closed8", "chips": 1, "why": "x"},
        {"name": "dummy-mla.closed8", "config": "dummy-mla",
         "traffic": "closed8", "chips": 1, "why": "y"}]
    bench["end_to_end"][0]["workloads"] += ["dummy-lm.closed8",
                                            "dummy-mla.closed8"]
    mfu = next(m for m in bench["per_layer"] if m["name"] == "decode_mfu")
    mfu["workloads"].append("dummy-mla.closed8")
    bench["per_layer"] += [
        {"name": "slots_per_step", "unit": "slots", "better": "higher",
         "source": "program_span", "layer": "batcher and replica",
         "moves": "tokens_per_s", "workloads": ["dummy-lm.closed8"]},
        {"name": "mla_decode_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels",
         "moves": "tokens_per_s", "workloads": ["dummy-mla.closed8"]}]
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

    # the latent family: its reference found by name, and imports as the
    # others may; its cut written down
    monkeypatch.setattr(reference, "__path__",
                        [str(fb / "reference")] + list(reference.__path__))
    monkeypatch.delitem(sys.modules, "reference.dummy_mla", raising=False)
    w = man.cell("dummy-mla.closed8")
    spec = man.config(w["config"])
    ref = man.reference(spec)
    assert ref.__file__ == str(fb / "reference" / "dummy_mla.py")
    assert set(_imports(ref.__file__)) == {"__future__"}
    assert cut_written_down(bench["configs"][-1], spec) == []
    # the program's config from the callable the reference names
    import repro_torch.models.api as api

    monkeypatch.setattr(api, "LatentConfig", lambda **kw: ("latent", kw),
                        raising=False)
    assert build_program_cfg(ref, spec) == (
        "latent", {"n_layers": 27, "kv_lora_rank": 512})
    # the reference's operation count, and the kernel's device time
    assert [m["name"] for m in man.metrics(w["name"], "per_layer")] == [
        "decode_mfu", "mla_decode_roofline"]
    rec = Record(spec=spec, mix=man.traffic(w["traffic"]), family=ref.FAMILY)
    rec.steps, rec.w_end = [(1.0, 0.01, 2, 2, [10, 20])], 2.0
    rec.trace = {"kernels": {"void mla_decode_kernel<bf16>": (1e-3, 4),
                             "decode_attention_kernel<x>": (1.0, 9)}}
    flops = 2 * 2.0 * 2048 ** 2 + 1e3 * 30
    assert man.reader("decode_mfu")(rec) == pytest.approx(
        100 * flops / (0.01 * 989e12))
    assert readers.decode_mfu(rec) == man.reader("decode_mfu")(rec)
    assert man.reader("mla_decode_roofline")(rec) == pytest.approx(
        100 * 4e6 / 3.35e9)
