"""The readings a cell's limits are set from, on the card, in one process.

    python3 faasbench/control.py --workload <name> --seeds 1,2,3 --seconds 10

For each seed: one run of the cell (a window of ``--seconds`` at the cell's
own load and sizes), then the comparison of ``harness/check.py`` on its
sample three times: the served tokens (the program's reading), the tokens
the reference computed in fp8 puts first at the same positions (the
control's reading), and those of the reference with its products' inputs
rounded to bf16 (a witness of what bf16 rounding alone gives). One JSON line a seed, then a summary: the largest program
reading and the smallest control reading. The benchmark's own runs do not
run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(man, name, seed, seconds, t0):
    """The program's, the control's and the bf16 witness's gaps (of
    ``check.served_gap``) on one seed's run, with its orchestrator counts."""
    from harness import check
    from harness.cell import run_cell

    cell = man.cell(name)
    spec = man.config(cell["config"])
    ref = man.reference(spec)
    rec, lb = run_cell(spec, man.traffic(cell["traffic"]), ref, seed,
                       seconds, False, t0)
    prog = check.served_gap(rec, ref, seed, lb.device)
    ctrl = check.served_gap(rec, ref, seed, lb.device, control="fp8")
    witness = check.served_gap(rec, ref, seed, lb.device, control="bf16")
    return {"seed": seed, "program": prog, "control": ctrl,
            "bf16_witness": witness, "orchestrator": check.orchestrator(rec)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.join(ROOT, "src"))
    import run

    run.set_env()
    import torch

    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 3
    from harness.manifest import Manifest

    man = Manifest(ROOT)
    rows = []
    for s in args.seeds.split(","):
        rows.append(readings(man, args.workload, int(s), args.seconds,
                             time.perf_counter()))
        print(json.dumps(rows[-1]), flush=True)
    keys = ("max_gap", "mean_gap", "worst_request_gap", "off_best")
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(),
                      "program_max": {k: max(r["program"][k] for r in rows)
                                      for k in keys},
                      "control_min": {k: min(r["control"][k] for r in rows)
                                      for k in keys},
                      "bf16_witness_max": {
                          k: max(r["bf16_witness"][k] for r in rows)
                          for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
