"""The traffic generator: deterministic per seed, the same work in every
round under every seed in another order, the mix's lengths, and a client
that keeps one round in flight."""
import numpy as np
import pytest

from harness import traffic as T
from harness.manifest import Manifest
from test_faasbench_manifest import ROOT

MAN = Manifest(ROOT)
MIX = MAN.traffic("closed")
SEED = 2 ** 31 + 12345            # beyond 32 signed bits


def _rounds(seed, n=3, vocab=1000):
    r = T.Requests(MIX, seed, vocab)
    return [r.round() for _ in range(n)]


@pytest.mark.parametrize("name", ["closed"])
def test_requests_deterministic_per_seed(name):
    assert MAN.traffic(name) == MIX
    assert _rounds(SEED) == _rounds(SEED)
    a, b = _rounds(SEED), _rounds(SEED + 1)
    assert a != b
    # the seed changes the ids, never the work or its order: every round
    # holds the same (prompt, output) lengths, in an order of its own
    work = sorted(T.round_lengths(MIX))
    shape = [[(len(p), n) for p, n in rnd] for rnd in a]
    assert shape == [[(len(p), n) for p, n in rnd] for rnd in b]
    assert all(sorted(rnd) == work for rnd in shape)
    assert shape[0] != shape[1]


def test_lengths_follow_the_mix():
    pairs = np.array(T.round_lengths(MIX))
    p, o = pairs[:, 0], pairs[:, 1]
    pl, ol = MIX["prompt_len"], MIX["output_len"]
    assert len(pairs) == MIX["fanout"] == MIX["slots"]
    assert p.min() >= pl["min"] and p.max() == pl["max"]
    assert o.min() >= ol["min"] and o.max() == ol["max"]   # clips reached
    assert abs(np.median(p) - pl["median"]) <= 1
    assert abs(np.median(o) - ol["median"]) <= 1
    # every request gets all its tokens within the replica's cache
    assert (p + o).max() <= MIX["max_seq"] - 1
    # prompt and output lengths paired across their ranges, not in order
    assert abs(np.corrcoef(p, o)[0, 1]) < 0.3
    toks = T.Requests(MIX, SEED, 49152).round()[0][0]
    assert all(0 <= t < 49152 for t in toks)


def test_closed_loop_keeps_its_clients():
    """On the DES alone (no live backend: each invocation's service is its
    modeled time), a round is sent only once the last is done, and the
    client stops sending at ``stop_at``."""
    import time

    from harness.cell import Driver
    from harness.des import SWEEP_SCALING, make_dirigent, preload_functions
    from repro_torch.simcore import Environment

    mix = dict(MIX, fanout=12)
    env = Environment(seed=0)
    cl = make_dirigent(env, n_workers=2, sandbox_concurrency=4)
    preload_functions(cl, ["fn"], dict(SWEEP_SCALING, **mix["scaling"]))
    drv = Driver(env, cl, mix, SEED, 100)
    in_flight = []
    real = drv.invoke

    def invoke(prompt, n):
        in_flight.append(len(drv.sent) - drv.completed)
        return real(prompt, n)

    drv.invoke = invoke
    drv.start()
    for _ in range(200):
        env.run(until=env.now + 0.01)
    assert drv.completed > 50 and len(drv.sent) % 12 == 0
    assert in_flight == [k % 12 for k in range(len(in_flight))]
    drv.stop_at = time.perf_counter()
    sent = len(drv.sent)
    for _ in range(200):
        env.run(until=env.now + 0.01)
    assert len(drv.sent) == sent and drv.completed == sent
