"""End-to-end serving driver of the PyTorch port: the serve launcher's path,
then continuous batching inside one replica.

  * ``repro_torch.launch.serve``: a Dirigent cluster in live mode; each
    invocation carries a ``LiveRequest`` that the worker hands to the
    replica of the sandbox the data plane picked (``LiveBackend``), and the
    backend's teardown hook frees a replica when its sandbox goes. Every
    request's tokens are checked against a solo replica drawn from its
    sandbox's seed, so a request served by another sandbox's replica fails
    the run;
  * the ``ContinuousBatcher`` driven directly: slot-level batched decoding,
    its output against single-request generation.

Run:  PYTHONPATH=src python examples/serve_llm_torch.py [--device cuda]
"""
import argparse
import time

from repro_torch.launch import serve
from repro_torch.serving.engine import ContinuousBatcher, Replica


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    out = serve.main(["--device", args.device, "--rate", "40"])
    cfg, backend = out["cfg"], out["backend"]
    solo = {}
    for inv in out["invocations"]:
        sid = backend.sandbox_of[id(inv.request)]
        if sid not in solo:
            solo[sid] = Replica(cfg, rng_seed=sid, max_seq=serve.MAX_SEQ,
                                device=args.device)
        want = solo[sid].generate(inv.request.prompt,
                                  max_new_tokens=inv.request.max_new_tokens)
        assert inv.request.tokens == want, f"request {inv.inv_id}"
    print(f"every request's tokens equal its own sandbox's replica "
          f"({len(solo)} sandboxes served)")

    # -- continuous batching inside one replica ------------------------------
    prompts = [[1, 5, 9], [2, 6], [3, 7, 11, 13], [4, 8, 12]]
    rep = Replica(cfg, max_seq=96, device=args.device)
    cb = ContinuousBatcher(rep, max_slots=4)
    rids = [cb.add_request(p, max_new=8) for p in prompts]
    t0 = time.perf_counter()
    cb.run_until_done()
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in cb.finished.values())
    print(f"\ncontinuous batcher: {len(rids)} requests, {tokens} tokens in "
          f"{cb.steps} lockstep decode steps ({tokens / dt:.0f} tok/s wall)")
    single = rep.generate(prompts[0], max_new_tokens=8)
    assert cb.finished[rids[0]] == single, "batched != single-request output"
    print("batched output == single-request output (exactness check passed)")


if __name__ == "__main__":
    main()
