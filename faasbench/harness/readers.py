"""The arithmetic of the metrics, on a run's ``cell.Record``. Each metric's
own file under ``metrics/`` names the function that reads it; a function
that finds nothing to read returns None, and the metric is then left out
of the result line."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from harness import costs
from harness.cell import hook_seconds
from harness.manifest import Manifest


def setup_s(rec) -> float:
    return rec.setup_s


def tokens_per_s(rec) -> Optional[float]:
    """Output tokens the batchers produced in the window, each counted at
    the step that produced it, over the window's wall seconds."""
    made = sum(r[3] for r in rec.steps_in_window())
    return made / rec.window_s if made else None


def orchestrator_ms_per_inv(rec) -> Optional[float]:
    """Host wall of the DES outside the live backend's hooks, per
    invocation completed, both over the window's loop (to ``w_stop``)."""
    if not rec.completed_in_window:
        return None
    return 1e3 * (rec.des_wall_s - hook_seconds(rec)) \
        / rec.completed_in_window


def step_ms(rec) -> Optional[float]:
    """Wall inside ``ContinuousBatcher.step`` per step, in the window."""
    steps = rec.steps_in_window()
    if not steps:
        return None
    return 1e3 * sum(r[1] for r in steps) / len(steps)


def _token_flops(rec) -> Optional[Callable[[int], float]]:
    """The operations of one decoded token at ``positions``: the
    configuration's reference module's ``token_flops`` where it defines
    one, else the frozen count of the ``dense`` and ``ssm`` families; None
    for any other."""
    ref = Manifest.reference(rec.spec)
    if hasattr(ref, "token_flops"):
        return lambda n: ref.token_flops(rec.spec, n)
    if rec.family in costs.FAMILIES:
        return lambda n: costs.token_flops(rec.spec, rec.family, n)
    return None


def decode_mfu(rec) -> Optional[float]:
    """The model operations of every active slot's token, over the steps'
    wall times the card's peak, in per cent, over the window's steps."""
    steps = rec.steps_in_window()
    count = _token_flops(rec)
    if not steps or count is None:
        return None
    flops = sum(count(n) for r in steps for n in r[4])
    wall = sum(r[1] for r in steps)
    peak = costs.PEAK_FLOPS[rec.spec["torch_dtype"]]
    return 100.0 * flops / (wall * peak)


def decode_attention_roofline(rec) -> Optional[float]:
    """K1's least time for the calls of the traced slice (every layer of
    every step, at the lengths each was given) over its device time there,
    in per cent; None unless the trace holds exactly those launches."""
    t = rec.trace
    n_l = rec.spec["num_hidden_layers"]
    if not t or not t["kernel_s"] or \
            t["kernel_launches"] != n_l * len(rec.k1_lens):
        return None
    s = rec.spec
    item = costs.ITEM[s["torch_dtype"]]
    least_ms = 0.0
    for lens in rec.k1_lens:
        nbytes, flops = costs.decode_cost(
            len(lens), rec.mix["max_seq"], s["num_attention_heads"],
            s["num_key_value_heads"], s["head_dim"], [n + 1 for n in lens],
            item)
        least_ms += n_l * costs.bound(nbytes, flops,
                                      s["torch_dtype"])["bound_ms"]
    return 100.0 * least_ms / (1e3 * t["kernel_s"])


def kernel_time(rec, part: str) -> Tuple[float, int]:
    """Device seconds and launches in the traced slice, summed over the
    operations whose name holds ``part``; (0.0, 0) without a trace."""
    kernels = (rec.trace or {}).get("kernels", {})
    got = [v for name, v in kernels.items() if part in name]
    return sum(s for s, _ in got), sum(n for _, n in got)


def device_idle_share(rec) -> Optional[float]:
    """Share of the traced slice in which the device ran nothing."""
    t = rec.trace
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
