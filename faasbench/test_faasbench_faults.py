"""A whole run of each cell at a small size on the CPU (everything but the
look for a card), sound and with the served path broken underneath: the
comparison must call the sound run correct and each fault not correct.
The faults a served cell can have: a token altered where it is produced,
a step that returns its state unchanged, half of the batch left out (its
logits the mean over the rest). The cells run on one chip: no exchange
between chips to leave out."""
import time

import pytest
import torch

from harness.manifest import Manifest
from harness.measure import measure
from test_faasbench_manifest import ROOT
from test_faasbench_reference import TINY

MAN = Manifest(ROOT)
CELLS = [w["name"] for w in MAN.bench["workloads"]]
SEED = 2 ** 31 + 99
# a small load, so that a run on the CPU takes seconds
SMALL = dict(fanout=32, slots=32, max_seq=96,
             prompt_len=dict(median=16, sigma=0.5, min=4, max=48),
             output_len=dict(median=12, sigma=0.5, min=4, max=32))


def _model_cls(cell):
    from repro_torch.models.rwkv import RWKV6Model
    from repro_torch.models.transformer import DecoderLM

    return RWKV6Model if cell.startswith("rwkv") else DecoderLM


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
    name = MAN.cell(cell)["config"]
    out = measure(MAN, cell, SEED, 1.0, False, time.perf_counter(),
                  device="cpu", spec_patch=TINY[name], mix_patch=SMALL)
    assert out["attempted"] > 0
    assert out["correct"] is (fault == "sound"), out["checks"]


def test_setup_that_never_pumps_fails(monkeypatch):
    """A run whose set-up admits and pumps nothing ends with an error, not
    a window that never opens."""
    from harness import cell

    monkeypatch.setattr(cell, "SETUP_WALL_S", 0.0)
    name = MAN.cell(CELLS[0])["config"]
    with pytest.raises(RuntimeError, match="set-up"):
        measure(MAN, CELLS[0], SEED, 1.0, False, time.perf_counter() - 1.0,
                device="cpu", spec_patch=TINY[name], mix_patch=SMALL)
