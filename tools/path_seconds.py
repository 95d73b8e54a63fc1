"""Each path's seconds in a ``chip_smoke.py`` that predates its own record
of them (PR 21's and earlier): runs the script found in the directory given
as the first argument (the repo's root by default) as it runs itself, with
its ``run_path`` timed as the newer script times it, and prints one JSON
line ``{"path_seconds": {...}}`` after the script's own lines. To compare
the paths of two trees on one card, unpack the other into ``_parent/``:

    python3 tools/path_seconds.py _parent; python3 chip_smoke.py
"""
import json, os, sys, time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)        # spawned ranks import the script by name
import chip_smoke as cs         # noqa: E402

seconds, run_path = {}, cs.run_path


def timed(name, serve_records):
    t0 = time.perf_counter()
    try:
        return run_path(name, serve_records)
    finally:
        seconds[name] = time.perf_counter() - t0


if __name__ == "__main__":
    cs.run_path = timed
    try:
        code = cs.main()
    except cs.SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    print(json.dumps({"path_seconds": seconds}), flush=True)
    sys.exit(code)
