"""The port's launchers and examples on the CPU: the serve launcher hands
each request to the replica of the sandbox it was invoked on (the
reference's runs every payload on its first replica, ROADMAP §C7) and frees
the replicas through the teardown hook; the train launcher checkpoints,
resumes and refuses what it does not port yet."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.serving.engine import Replica  # noqa: E402
from repro_torch.train.checkpoint import latest_step  # noqa: E402
from torch_port_util import torch_threads  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def served():
    """The reference's traffic (24 requests, 4 workers) at a rate that
    makes the autoscaler start several sandboxes."""
    return serve.main(["--device", "cpu", "--rate", "40"])


def test_serve_launcher_serves_every_request(served):
    assert served["ok"] == 24
    for inv in served["invocations"]:
        assert len(inv.request.tokens) == 8
        assert all(0 <= t < served["cfg"].vocab for t in inv.request.tokens)


def test_each_request_runs_on_its_own_sandboxs_replica(served):
    """Each sandbox's replica draws its weights from its sandbox id, so a
    request's tokens equal a solo replica of the sandbox it was admitted to
    and of no other."""
    backend = served["backend"]
    sids = {backend.sandbox_of[id(i.request)] for i in served["invocations"]}
    assert len(sids) >= 2
    solo = {s: Replica(served["cfg"], rng_seed=s, max_seq=serve.MAX_SEQ,
                       device="cpu") for s in sids}
    for inv in served["invocations"]:
        sid = backend.sandbox_of[id(inv.request)]
        want = solo[sid].generate(inv.request.prompt, max_new_tokens=8)
        assert inv.request.tokens == want, inv.inv_id
    # the check can tell the replicas apart: another sandbox's weights
    # give other tokens for the first request
    first = served["invocations"][0]
    other = [r for s, r in solo.items()
             if s != backend.sandbox_of[id(first.request)]]
    assert any(r.generate(first.request.prompt, max_new_tokens=8)
               != first.request.tokens for r in other)


def test_serve_launcher_frees_every_replica(served):
    backend = served["backend"]
    assert backend.replicas_live == 0
    assert backend.teardowns == len(backend.start_log) == served["replicas"]


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    common = ["--reduced", "--device", "cpu", "--seq", "16", "--batch", "4",
              "--ckpt-dir", ck, "--ckpt-every", "20"]
    first = train.main(common + ["--steps", "30"])
    assert latest_step(ck) == 30 and sorted(os.listdir(ck)) == [
        "step_00000020", "step_00000030"]
    again = train.main(common + ["--steps", "10", "--resume"])
    assert (again["start"], again["end"]) == (30, 40)
    out = capsys.readouterr().out
    assert "[train] resumed from step 30" in out
    assert "[train] step    20 loss" in out and "[train] done at step 40" in out
    # the same data order: a run of 40 steps from scratch ends where the
    # resumed one does
    whole = train.main(["--reduced", "--device", "cpu", "--seq", "16",
                        "--batch", "4", "--ckpt-dir", str(tmp_path / "w"),
                        "--ckpt-every", "100", "--steps", "40"])
    assert whole["losses"][30:] == again["losses"]
    assert first["losses"][-1] < first["losses"][0]


def test_train_launcher_defaults_to_the_gpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("script,args", [
    ("serve_llm_torch.py", []),
    ("train_smollm_torch.py", ["--steps", "30", "--ckpt-every", "15"])])
def test_example_runs_on_the_cpu(script, args, tmp_path):
    extra = ["--out", str(tmp_path / "out")] if "train" in script else []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script),
         "--device", "cpu", *args, *extra], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "continues the trajectory" in out.stdout or \
        "exactness check passed" in out.stdout
