"""The metric arithmetic on hand-made records: a rate over the window, the
step's time and the model's operations over the window's steps, K1's and
K3d's bounds, the trace's busy time, idle gaps and kernel table."""
from types import SimpleNamespace

import pytest
import torch

from harness import costs, readers
from harness.cell import Record
from harness.manifest import Manifest
from harness.trace import Trace
from test_faasbench_manifest import ROOT

SMOLLM = dict(num_hidden_layers=32, hidden_size=960, intermediate_size=2560,
              num_attention_heads=15, num_key_value_heads=5, head_dim=64,
              vocab_size=49152, torch_dtype="bfloat16",
              reference="transformer")
RWKV6 = dict(num_hidden_layers=32, hidden_size=4096, head_size=64,
             intermediate_size=14336, vocab_size=65536,
             torch_dtype="bfloat16", reference="rwkv6")


def _rec(**kw):
    r = Record(spec=SMOLLM, mix={"max_seq": 512}, family="dense")
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_rate_over_the_window():
    # steps: (end, wall, active, made, positions); the last ends after w_end
    steps = [(1.5, 0.01, 4, 3, [5] * 4), (2.0, 0.01, 4, 4, [6] * 4),
             (12.5, 0.01, 4, 4, [7] * 4)]
    rec = _rec(steps=steps, w0=1.0, w_end=11.0, w_stop=12.6)
    assert readers.tokens_per_s(rec) == pytest.approx(7 / 10.0)
    assert readers.step_ms(rec) == pytest.approx(10.0)


def test_step_metrics_read_the_window_alone():
    """A step that ends after the window's end counts in none of the
    three metrics, however long it took."""
    inside = [(1.5, 0.01, 4, 3, [5] * 4), (2.0, 0.01, 4, 4, [6] * 4)]
    late = [(12.5, 0.5, 64, 64, [900] * 64)]
    a = _rec(steps=inside, w0=1.0, w_end=11.0)
    b = _rec(steps=inside + late, w0=1.0, w_end=11.0)
    for read in (readers.tokens_per_s, readers.step_ms,
                 readers.decode_mfu):
        assert read(b) == pytest.approx(read(a)), read.__name__


def test_decode_mfu_counts_the_active_slots():
    steps = [(1.0, 0.005, 2, 2, [10, 20]), (2.0, 0.005, 1, 1, [30])]
    rec = _rec(steps=steps, w_end=2.0)
    d, f, hq, hkv, hd, v, n_l = 960, 2560, 15, 5, 64, 49152, 32
    mats = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * f
    flops = sum(n_l * (2 * mats + 4 * hq * hd * p) + 2 * d * v
                for p in (10, 20, 30))
    assert readers.decode_mfu(rec) == pytest.approx(
        100 * flops / (0.01 * 989e12))


def test_k1_bound_counts():
    nbytes, flops = costs.decode_cost(2, 512, 15, 5, 64, [10, 600], 2)
    live = 10 + 512                           # clipped to the cache
    assert nbytes == (2 * live * 5 * 64 + 2 * 2 * 15 * 64) * 2 + 8
    assert flops == 4.0 * live * 15 * 64
    b = costs.bound(nbytes, flops, "bfloat16")
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    lens = [[9, 599]] * 3                    # as the steps were given them
    trace = {"kernel_s": 1e-3, "kernel_launches": 3 * 32}
    rec = _rec(k1_lens=lens, trace=trace)
    assert readers.decode_attention_roofline(rec) == pytest.approx(
        100 * 3 * 32 * b["bound_ms"] / 1.0)
    trace["kernel_launches"] = 95             # the trace lost one: no reading
    assert readers.decode_attention_roofline(rec) is None


class _Ev:
    def __init__(self, name, start, end, cuda):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda \
            else torch.autograd.DeviceType.CPU


def _traced():
    """The reduction of a hand-made slice of 100 us."""
    t = Trace(SimpleNamespace())
    t.t0, t.t1 = 0.0, 100e-6
    t.prof = SimpleNamespace(events=lambda: [
        _Ev("des.run", 0, 100, False),
        _Ev("batcher.step", 10, 60, False),
        _Ev("batcher.step", 10, 60, True),    # its annotation on the device
        _Ev("k_a", 10, 30, True), _Ev("decode_attention_kernel<x>", 25, 40,
                                      True),
        _Ev("k_a", 50, 60, True)])
    return t.reduce("decode_attention_kernel")


def test_trace_busy_and_gaps():
    r = _traced()
    assert r["window_s"] == pytest.approx(1e-4)
    assert r["busy_s"] == pytest.approx(40e-6)       # 10..40 and 50..60
    gaps = dict(r["idle_gaps"])
    assert gaps["batcher.step"] == pytest.approx(10e-6)   # 40..50
    assert gaps["des.run"] == pytest.approx(50e-6)        # 0..10, 60..100
    assert r["kernel_s"] == pytest.approx(15e-6)
    assert r["kernel_launches"] == 1
    assert dict(r["device_ops"])["k_a"] == pytest.approx(30e-6)
    rec = _rec(trace=r)
    assert readers.device_idle_share(rec) == pytest.approx(60.0)


def test_trace_kernel_table():
    """Every device operation with its summed seconds and launches, names
    whole; the annotation of a span is none of them."""
    r = _traced()
    assert set(r["kernels"]) == {"k_a", "decode_attention_kernel<x>"}
    s, n = r["kernels"]["k_a"]
    assert s == pytest.approx(30e-6) and n == 2
    rec = _rec(trace=r)
    s, n = readers.kernel_time(rec, "k_")
    assert s == pytest.approx(30e-6) and n == 2
    assert readers.kernel_time(rec, "kernel") == (pytest.approx(15e-6), 1)
    assert readers.kernel_time(rec, "wkv6") == (0.0, 0)
    assert readers.kernel_time(_rec(), "k_a") == (0.0, 0)


def test_decode_mfu_takes_the_references_count(monkeypatch):
    """A reference's own ``token_flops`` counts a token, whatever its
    family; a family the frozen count does not know, with no count of its
    own, reads nothing."""
    import reference.transformer as ref

    steps = [(1.0, 0.005, 2, 2, [10, 20]), (2.0, 0.005, 1, 1, [30])]
    rec = _rec(steps=steps, w_end=2.0)
    rec.family = "mla"
    assert readers.decode_mfu(rec) is None
    seen = []

    def count(spec, positions):
        seen.append((spec["name"], positions))
        return 1e9 * positions

    monkeypatch.setattr(ref, "token_flops", count, raising=False)
    rec.spec = dict(SMOLLM, name="x")
    assert readers.decode_mfu(rec) == pytest.approx(
        100 * 60e9 / (0.01 * 989e12))
    assert sorted(seen) == [("x", 10), ("x", 20), ("x", 30)]


WKV6 = "void (anonymous namespace)::wkv6_decode_kernel<__nv_bfloat16, 4>"


def test_wkv6_decode_roofline():
    """K3d's least time: every layer of every traced step over all the
    slots, the state read only for rows whose given length is not 0."""
    read = Manifest(ROOT).reader("wkv6_decode_roofline")
    lens = [[0] * 60 + [5, 0, 7, 1], [3] * 64]       # 3 then 64 live rows
    trace = {"kernels": {WKV6: (2e-3, 64), "k_a": (1.0, 64)}}
    rec = Record(spec=RWKV6, mix={"max_seq": 1024}, family="ssm")
    rec.k1_lens, rec.trace = lens, trace
    least = sum(32 * costs.bound(*costs.wkv6_decode_cost(
        64, 64, 64, 64, 2, live), "float32")["bound_ms"] for live in (3, 64))
    assert read(rec) == pytest.approx(100 * least / 2.0)
    one = costs.bound(*costs.wkv6_decode_cost(64, 64, 64, 64, 2, 64),
                      "float32")
    assert one["bound_by"] == "bytes"
    assert 32 * one["bound_ms"] == pytest.approx(1.317, abs=1e-3)
    none = costs.wkv6_decode_cost(64, 64, 64, 64, 2, 0)[0]
    assert 32 * none / 3.35e9 == pytest.approx(0.676, abs=1e-3)
    trace["kernels"][WKV6] = (2e-3, 63)        # the trace lost one launch
    assert read(rec) is None
    rec.trace = None
    assert read(rec) is None


def test_gap_stats_see_one_request_wrong():
    """Two of twelve requests wrong: the mean gap is diluted by the other
    ten, the worst request's mean gap is not."""
    from harness.check import gap_stats

    sound = [[0.0, 0.1, 0.0, 0.1]] * 10
    wrong = [[3.0, 2.0, 4.0, 3.0]] * 2
    s = gap_stats(sound + wrong)
    assert s["worst_request_gap"] == pytest.approx(3.0)
    assert s["mean_gap"] == pytest.approx((10 * 0.2 + 2 * 12.0) / 48)
    assert s["max_gap"] == 4.0 and s["off_best"] == pytest.approx(28 / 48)
    assert gap_stats([])["worst_request_gap"] == 0.0


def test_sample_holds_the_longest_and_twelve():
    from harness.check import SAMPLED, sample

    def inv(k, n):
        return SimpleNamespace(inv_id=k, failed=False, t_done=1.0,
                               request=SimpleNamespace(prompt=[1] * 5,
                                                       tokens=[2] * n))

    invs = [inv(k, 10 + k % 7) for k in range(40)] + [inv(40, 500)]
    rec = _rec(sent=invs)
    a, b = sample(rec, 3), sample(rec, 4)
    assert len(a) == SAMPLED == 12 and a[0] is invs[40]
    assert len({id(i) for i in a}) == 12 and a != b
    assert sample(rec, 3) == a
    few = _rec(sent=invs[:5])
    assert len(sample(few, 3)) == 5


def _golden_records():
    """A record of each kind the tests above build, with every field the
    readers take."""
    steps = [(1.5, 0.01, 4, 3, [5] * 4), (2.0, 0.012, 4, 4, [6] * 4),
             (12.5, 0.01, 4, 4, [7] * 4)]
    win = dict(steps=steps, w0=1.0, w_end=11.0, w_stop=12.6, setup_s=12.5,
               completed_in_window=7, des_wall_s=0.5,
               spans={"backend.admit": 0.01, "backend.collect": 0.2})
    rwkv = Record(spec=RWKV6, mix={"max_seq": 1024}, family="ssm")
    for k, v in win.items():
        setattr(rwkv, k, v)
    return {"dense": _rec(k1_lens=[[9, 599]] * 3, trace=dict(
                _traced(), kernel_s=1e-3, kernel_launches=96), **win),
            "ssm": rwkv, "traced": _rec(trace=_traced(), **win)}


# each reader's value on those records as the benchmark's first version
# read it (before ``token_flops`` came from the reference and the trace
# kept every kernel): the accepted cells' metrics read the same numbers
GOLDEN = {
    "setup_s": (12.5, 12.5, 12.5),
    "tokens_per_s": (0.7, 0.7, 0.7),
    "orchestrator_ms_per_inv": (41.42857142857143,) * 3,
    "step_ms": (11.0, 11.0, 11.0),
    "decode_mfu": (0.02662720029414468, 0.536056648736097,
                   0.02662720029414468),
    "decode_attention_roofline": (1.9367584477611939, None, None),
    "device_idle_share": (60.00000000000001, None, 60.00000000000001),
}


@pytest.mark.parametrize("metric", sorted(GOLDEN))
def test_accepted_metrics_read_as_before(metric):
    read = Manifest(ROOT).reader(metric)
    got = tuple(read(r) for r in _golden_records().values())
    assert got == GOLDEN[metric]
