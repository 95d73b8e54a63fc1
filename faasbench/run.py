"""One run of one benchmark cell of the PyTorch/CUDA port (``repro_torch``).

    python3 faasbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card. The cell, its
configuration, traffic mix and metrics are read from ``BENCHMARK.json`` and
the files it names under ``faasbench/``. With ``--trace 0`` the result
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones (``torch.profiler`` over the window's first seconds). The
last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines on standard error). Exits non-zero with no
result without a CUDA card, without the program's sources beside this
folder, or if JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def set_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout,
    and no JAX from a library that could load it."""
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = build
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    set_env()
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.join(ROOT, "src"))
    from harness.manifest import Manifest

    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 4
    from harness.measure import emit, forbidden_modules, measure
    from repro_torch.kernels import ops

    out = measure(man, args.workload, args.seed, args.seconds,
                  bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 5
    if args.trace:
        print("launches " + str(ops.launch_counts()))
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
