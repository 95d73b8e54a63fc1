"""The import guard compares whole top-level names, and the benchmark
exits without a result where it cannot measure."""
import os
import shutil
import subprocess
import sys

from harness import measure
from test_faasbench_manifest import ROOT


def test_guard_by_top_level_name(monkeypatch):
    fake = dict.fromkeys(["repro_torch", "repro_torch.core", "jaxtyping",
                          "reprolib", "torch"])
    monkeypatch.setattr(sys, "modules", fake)
    assert measure.forbidden_modules() == []
    fake.update(dict.fromkeys(["repro", "repro.core.cluster", "jax.numpy",
                               "jaxlib", "flax.linen"]))
    assert measure.forbidden_modules() == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.cluster"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "faasbench/run.py", "--workload",
         "smollm-360m.closed", "--seed", "4294967301", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(os.path.join(ROOT, "faasbench"), tmp_path / "faasbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
