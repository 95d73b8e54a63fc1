"""A whole run of each cell at a small size on the CPU (everything but the
look for a card), sound and with the served path broken underneath: the
comparison must call the sound run correct and each fault not correct.
The faults a served cell can have: a token altered where it is produced,
a step that returns its state unchanged, half of the batch left out (its
logits the mean over the rest), the last two in the model class the run
builds. The cells run on one chip: no exchange between chips to leave
out. The cells, their small sizes (each reference's ``TINY``) and their
model classes come from the manifest and the files it names, so a
configuration added by new files alone is run here too."""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from harness.manifest import Manifest
from harness.measure import measure
from test_faasbench_manifest import ROOT, _digest
from test_faasbench_reference import tiny_patch

MAN = Manifest(ROOT)
CELLS = [w["name"] for w in MAN.bench["workloads"]]
SEED = 2 ** 31 + 99
# a small load, so that a run on the CPU takes seconds
SMALL = dict(fanout=32, slots=32, max_seq=96,
             prompt_len=dict(median=16, sigma=0.5, min=4, max=48),
             output_len=dict(median=12, sigma=0.5, min=4, max=32))


def _model_cls(cell):
    """The model class a run of ``cell`` builds, from the program config
    its files give (at the CPU tests' size)."""
    from harness.cell import build_program_cfg
    from repro_torch.models.api import build_model

    spec = dict(MAN.config(MAN.cell(cell)["config"]), **tiny_patch(MAN, cell))
    cfg = build_program_cfg(MAN.reference(spec), spec)
    return type(build_model(cfg, device="meta"))


def token_altered(monkeypatch, cell):
    from repro_torch.serving.engine import ContinuousBatcher

    step = ContinuousBatcher.step

    def altered(self):
        """Every token off by one as the step produces it."""
        fresh = [s.active and len(s.pending) <= 1 for s in self.slots]
        out = step(self)
        for s, f in zip(self.slots, fresh):
            if f and s.generated:
                s.generated[-1] = (s.generated[-1] + 1) % 256
        return out

    monkeypatch.setattr(ContinuousBatcher, "step", altered)


def state_unchanged(monkeypatch, cell):
    cls = _model_cls(cell)
    decode = cls.decode_step

    def frozen(self, cache, batch):
        keep = {k: v.clone() for k, v in cache.items()}
        logits, cache = decode(self, cache, batch)
        for k, v in keep.items():
            cache[k].copy_(v)
        return logits, cache

    monkeypatch.setattr(cls, "decode_step", frozen)


def half_batch(monkeypatch, cell):
    """Every other row of the batch left out, its logits the mean of the
    rows computed (the requests fill the low slots first, so the second
    half of the slots may never be used)."""
    cls = _model_cls(cell)
    decode = cls.decode_step

    def half(self, cache, batch):
        logits, cache = decode(self, cache, batch)
        out = logits.clone()
        out[1::2] = logits[0::2].mean(0, keepdim=True)
        return out, cache

    monkeypatch.setattr(cls, "decode_step", half)


FAULTS = {"sound": None, "token_altered": token_altered,
          "state_unchanged": state_unchanged, "half_batch": half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(monkeypatch, cell, fault):
    torch.set_num_threads(2)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch, cell)
    out = measure(MAN, cell, SEED, 1.0, False, time.perf_counter(),
                  device="cpu", spec_patch=tiny_patch(MAN, cell),
                  mix_patch=SMALL)
    assert out["attempted"] > 0
    assert out["correct"] is (fault == "sound"), out["checks"]


def test_setup_that_never_pumps_fails(monkeypatch):
    """A run whose set-up admits and pumps nothing ends with an error, not
    a window that never opens."""
    from harness import cell

    monkeypatch.setattr(cell, "SETUP_WALL_S", 0.0)
    with pytest.raises(RuntimeError, match="set-up"):
        measure(MAN, CELLS[0], SEED, 1.0, False, time.perf_counter() - 1.0,
                device="cpu", spec_patch=tiny_patch(MAN, CELLS[0]),
                mix_patch=SMALL)


NEW = "dense-lm"            # a configuration the copy below adds
NEW_TINY = dict(num_hidden_layers=1, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, intermediate_size=96,
                vocab_size=320, torch_dtype="float32")


def _add_config_by_files(root):
    """Into the checkout copy ``root``: a dense configuration of other
    widths, a reference module of its own (``transformer.py`` under a new
    name, with its own ``TINY``), its cell on ``closed``, and the cell
    appended to every metric's ``workloads`` (a reader that finds nothing,
    as another family's kernel, leaves its metric out). Returns the
    cell."""
    fb = root / "faasbench"
    spec = json.loads((fb / "configs" / "smollm-360m.json").read_text())
    spec.update(name=NEW, reference="dense_lm", num_hidden_layers=24,
                hidden_size=1024, num_attention_heads=16,
                num_key_value_heads=4, head_dim=64, intermediate_size=2816,
                vocab_size=32000)
    (fb / "configs" / f"{NEW}.json").write_text(json.dumps(spec))
    text, n = re.subn(r"^TINY = dict\(.*?\)\n", f"TINY = {NEW_TINY!r}\n",
                      (fb / "reference" / "transformer.py").read_text(),
                      count=1, flags=re.S | re.M)
    assert n == 1
    (fb / "reference" / "dense_lm.py").write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": NEW, "source": "x",
                             "file": f"faasbench/configs/{NEW}.json",
                             "reduced": [], "why": "x"})
    cell = f"{NEW}.closed"
    bench["workloads"].append({"name": cell, "config": NEW,
                               "traffic": "closed", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def test_new_config_enters_every_cell_test_by_files_only(tmp_path,
                                                         monkeypatch):
    """A configuration added as new files and manifest entries alone: no
    file that was there changes; the tests that run every configuration
    and cell, collected from the copy, have the new one's cases; and a
    sound run of its cell at the size its own ``TINY`` gives reads
    correct on the CPU."""
    import reference
    from harness.manifest import Manifest

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "faasbench"), root / "faasbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "faasbench")
    cell = _add_config_by_files(root)
    after = _digest(root / "faasbench")
    assert all(after[k] == v for k, v in before.items())

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "faasbench"], cwd=root, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    ids = {line.split("::", 1)[1] for line in out.stdout.splitlines()
           if "::" in line}
    want = {f"test_fault_is_caught[{cell}-{f}]" for f in FAULTS}
    want |= {f"test_forward_equals_recurrence[{NEW}]",
             f"test_weights_and_arithmetic_are_the_programs[{NEW}]",
             f"test_cell_files_found[{cell}]",
             f"test_traced_run_reports_the_program_spans[{cell}]"}
    assert want <= ids, sorted(want - ids)

    monkeypatch.setattr(reference, "__path__",
                        [str(root / "faasbench" / "reference")] +
                        list(reference.__path__))
    monkeypatch.delitem(sys.modules, "reference.dense_lm", raising=False)
    man = Manifest(str(root))
    assert tiny_patch(man, cell) == NEW_TINY
    torch.set_num_threads(2)
    res = measure(man, cell, SEED, 1.0, False, time.perf_counter(),
                  device="cpu", spec_patch=tiny_patch(man, cell),
                  mix_patch=SMALL)
    assert res["attempted"] > 0
    assert res["correct"] is True, res["checks"]
