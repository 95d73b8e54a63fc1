"""End-to-end training driver of the PyTorch port, with checkpoint/restart
onto another device.

Trains a reduced smollm-360m on the synthetic Zipf LM, saving checkpoints in
the background; then stands in for a node failure by restoring the newest
checkpoint into a fresh trainer on ANOTHER device (the reference's
examples/train_smollm.py restores onto a smaller mesh) and checks that the
loss trajectory continues from where it was rather than from the start.

Run:  PYTHONPATH=src python examples/train_smollm_torch.py [--steps 200] \
          [--full] [--device cuda] [--resume-device cpu]
      (--full uses the real 360M config; the resumed leg then runs on
       --device too)
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.launch.train import Trainer, run_config
from repro_torch.train.checkpoint import latest_step, save_checkpoint


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--out", type=str, default="results/train_smollm_torch")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--resume-device", type=str, default="cpu")
    args = ap.parse_args()

    if args.full:
        cfg = get_config("smollm-360m")
        seq, batch = 512, 8
        resume_device = args.device
    else:
        cfg = get_config("smollm-360m").reduced(
            n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
            vocab=2048)
        seq, batch = 64, 16
        resume_device = args.resume_device
    run = run_config(grad_accum=2)
    tr = Trainer(cfg, run, seq=seq, batch=batch, lr=3e-3, seed=11,
                 device=args.device)
    n_params = sum(p.numel() for p in tr.params.values())
    print(f"training {cfg.name} ({n_params/1e6:.1f}M params) "
          f"seq={seq} batch={batch} on {tr.device}")

    t0 = time.time()
    losses, writer = [], None
    for i in range(args.steps):
        m = tr.step(i)
        losses.append(float(m["loss"]))
        if (i + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = save_checkpoint(args.out, i + 1, tr.state(),
                                     async_save=True)
        if (i + 1) % 25 == 0:
            rate = batch * seq * 25 / (time.time() - t0)
            t0 = time.time()
            print(f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  {rate:,.0f} tok/s")
    if writer is not None:
        writer.join()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    # -- stand in for a node failure: restart on another device ---------------
    print(f"\nsimulating node failure: restoring the newest checkpoint "
          f"(step {latest_step(args.out)}) onto {resume_device}")
    # the same seed: the data stream must be the same; the weights and the
    # optimizer state come from the checkpoint
    tr2 = Trainer(cfg, run, seq=seq, batch=batch, lr=3e-3, seed=11,
                  device=resume_device)
    at = tr2.restore(args.out)
    resumed = [float(tr2.step(i)["loss"]) for i in range(at, at + 25)]
    print(f"resumed from step {at} on {tr2.device}; loss after 25 more "
          f"steps: {resumed[-1]:.4f} (continues the trajectory)")
    if not resumed[0] < losses[0]:
        raise SystemExit(f"the resumed run starts at loss {resumed[0]:.4f}, "
                         f"not below the first step's {losses[0]:.4f}")


if __name__ == "__main__":
    main()
