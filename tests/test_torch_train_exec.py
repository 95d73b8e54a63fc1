"""The compiled train step (``train_step.TrainExecutable``), the
counterpart of the reference's ``jax.jit(make_train_step(...))``, on the
CPU, where it runs its body eagerly on its static tensors (on CUDA the
same body is captured as a graph and replayed: ``chip_smoke.py``):

  * over 3 steps it equals ``make_train_step`` bit for bit (loss, grad
    norm, step, every parameter, both moments), for dense, RWKV6, Zamba2
    and Whisper, and with ``grad_accum=2``; its body reads nothing on the
    host;
  * ``Trainer.restore`` writes into the executable's static state, and
    the next step equals an eager trainer restored from the same
    checkpoint;
  * the rule (``eager_reason``): MoE, ``grad_compress`` and a mesh above
    one rank stay eager, ``compiled=True`` raises there; ``--eager``
    reaches the ``Trainer``; a CUDA executable that was not captured
    raises;
  * the launcher returns the losses it returned when it read each one
    after its step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.train import Trainer, run_config  # noqa: E402
from repro_torch.models.api import RunConfig, build_model  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from repro_torch.train.train_step import (WARM_STEPS,  # noqa: E402
                                          TrainExecutable, eager_reason,
                                          make_train_step)

from torch_port_util import (fake_mesh, no_host_reads,  # noqa: E402
                             torch_threads)

KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
FAMILIES = {"smollm-360m": KW, "rwkv6-7b": KW,
            "zamba2-2.7b": dict(KW, n_layers=4), "whisper-small": {}}
B, SEQ, LR = 4, 16, 1e-3
TRAINER = dict(seq=SEQ, batch=B, lr=LR, seed=0, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _model(name, accum=1):
    cfg = get_config(name).reduced(**FAMILIES[name])
    run = RunConfig(attn_impl="plain", q_chunk=8, kv_chunk=8, seq_chunk=8,
                    grad_accum=accum)
    return build_model(cfg, run, device="cpu").init_params(
        torch.Generator().manual_seed(0))


def _batches(model, n=3):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = rng.integers(0, model.cfg.vocab, (B, SEQ + 1)).astype(np.int32)
        b = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
        if model.cfg.family == "audio":
            b["frames"] = torch.from_numpy((rng.standard_normal(
                (B, model.enc_seq, model.cfg.d_model)) * 0.5).astype(
                    np.float32))
        out.append(b)
    return out


def _assert_states_equal(m1, o1, m2, o2):
    for (k, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(o1.step, o2.step)
    for k in o1.mu:
        assert torch.equal(o1.mu[k], o2.mu[k]), k
        assert torch.equal(o1.nu[k], o2.nu[k]), k


@pytest.mark.parametrize("name,accum", [(n, 1) for n in FAMILIES]
                         + [("smollm-360m", 2)])
def test_executable_equals_make_train_step(name, accum):
    eager, mine = _model(name, accum), _model(name, accum)
    step = make_train_step(eager, lr=LR)
    opt = adamw_init(dict(eager.named_parameters()))
    exe = TrainExecutable(make_train_step(mine, lr=LR),
                          adamw_init(dict(mine.named_parameters())),
                          _batches(mine, 1)[0], "cpu", who=name)
    for batch in _batches(eager):
        opt, m = step(opt, batch, None)
        got = exe(batch)
        for k in ("loss", "grad_norm", "step"):
            assert torch.equal(got[k], m[k]), k
        _assert_states_equal(eager, opt, mine, exe.opt)
    assert exe.eager_steps == 3 and exe.graph is None


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_step_body_reads_nothing_on_the_host(name):
    """The body a graph captures (the forward, the recompute, the backward
    and AdamW), with remat on as the trainer runs it."""
    model = _model(name)
    exe = TrainExecutable(make_train_step(model, lr=LR),
                          adamw_init(dict(model.named_parameters())),
                          _batches(model, 1)[0], "cpu", who=name)
    exe(_batches(model, 1)[0])
    with no_host_reads():
        exe._step()
    with pytest.raises(AssertionError, match="host"), no_host_reads():
        exe.metrics["loss"].item()


def test_restore_writes_into_the_static_state(tmp_path):
    ck = str(tmp_path / "ck")
    cfg = get_config("smollm-360m").reduced(**KW)
    run = run_config()
    first = Trainer(cfg, run, compiled=True, **TRAINER)
    assert first.compiled
    for i in range(3):
        first.step(i)
    first.save(ck, 3)
    mine = Trainer(cfg, run, compiled=True, **TRAINER)
    eager = Trainer(cfg, run, compiled=False, **TRAINER)
    assert not eager.compiled
    static = {k: t.data_ptr() for k, t in mine.exe.opt.mu.items()}
    step = mine.exe.opt.step
    assert mine.restore(ck) == eager.restore(ck) == 3
    assert mine.opt is mine.exe.opt and mine.exe.opt.step is step
    assert {k: t.data_ptr() for k, t in mine.exe.opt.mu.items()} == static
    _assert_states_equal(mine.model, mine.opt, first.model, first.opt)
    for i in (3, 4):
        got, want = mine.step(i), eager.step(i)
        assert torch.equal(got["loss"], want["loss"])
        _assert_states_equal(mine.model, mine.opt, eager.model, eager.opt)
    assert int(mine.opt.step) == 5


# -- the rule ---------------------------------------------------------------------

def test_the_rule_keeps_moe_compress_and_a_mesh_eager():
    dense = get_config("smollm-360m").reduced(**KW)
    moe = get_config("arctic-480b").reduced(**KW)
    for cfg, run in ((moe, run_config()), (dense, run_config(compress=True))):
        assert eager_reason(cfg, run) is not None
        assert not Trainer(cfg, run, **TRAINER).compiled
        with pytest.raises(ValueError, match="cannot be captured"):
            Trainer(cfg, run, compiled=True, **TRAINER)
    assert "mesh of 2 ranks" in eager_reason(dense, run_config(),
                                             fake_mesh((2, 1), (0, 0)))
    assert "mesh of 4 ranks" in eager_reason(dense, run_config(),
                                             fake_mesh((2, 2), (0, 0)))
    # one rank: no mesh, or a mesh of size-1 axes, as the launcher builds
    assert eager_reason(dense, run_config()) is None
    assert eager_reason(dense, run_config(), fake_mesh((1, 1), (0, 0))) \
        is None
    # the CPU has nothing to capture: eager unless asked
    assert not Trainer(dense, run_config(), **TRAINER).compiled
    assert Trainer(dense, run_config(), compiled=True, **TRAINER).compiled


def test_an_uncaptured_cuda_executable_raises():
    """After its warm steps a CUDA executable replays or raises: it never
    steps eagerly (the device is only named here; nothing reaches it)."""
    model = _model("smollm-360m")
    batch = _batches(model, 1)[0]
    exe = TrainExecutable(make_train_step(model, lr=LR),
                          adamw_init(dict(model.named_parameters())),
                          batch, "cpu")
    exe.device, exe.warm_steps = torch.device("cuda"), WARM_STEPS
    with pytest.raises(RuntimeError, match="not captured"):
        exe(batch)
    with pytest.raises(ValueError, match="shape"):
        exe({k: v[:1] for k, v in batch.items()})


@pytest.mark.parametrize("eager", [False, True])
def test_eager_flag_reaches_the_trainer(monkeypatch, tmp_path, eager):
    seen = []
    real = launch_train.Trainer

    def spy(*args, **kw):
        seen.append(kw["compiled"])
        return real(*args, **kw)

    monkeypatch.setattr(launch_train, "Trainer", spy)
    out = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--batch", "4", "--ckpt-dir",
                             str(tmp_path)] + (["--eager"] if eager else []))
    assert seen == [False if eager else None]
    assert out["trainer"].compiled is False


def test_launcher_losses_are_those_read_after_each_step(tmp_path):
    """25 steps: the losses read every 20 steps and at the end are the
    floats the launcher read after every step before."""
    out = launch_train.main(["--reduced", "--device", "cpu", "--steps", "25",
                             "--seq", "16", "--batch", "4", "--ckpt-dir",
                             str(tmp_path)])
    cfg = get_config("smollm-360m").reduced(
        n_layers=4, d_model=128, n_heads=4, d_ff=384, vocab=2048)
    tr = Trainer(cfg, run_config(), seq=16, batch=4, lr=3e-3, seed=0,
                 device="cpu")
    assert out["losses"] == [float(tr.step(i)["loss"]) for i in range(25)]


def test_remat_changes_no_bit_of_a_trainer_step():
    """The launcher's run config has remat on (the reference's default):
    three steps equal the same trainer's with it off, bit for bit."""
    cfg = get_config("smollm-360m").reduced(**KW)
    on = Trainer(cfg, run_config(), **TRAINER)
    off = Trainer(cfg, dataclasses.replace(run_config(), remat=False),
                  **TRAINER)
    assert on.model.run.remat and not off.model.run.remat
    for i in range(3):
        assert torch.equal(on.step(i)["loss"], off.step(i)["loss"])
        _assert_states_equal(on.model, on.opt, off.model, off.opt)
