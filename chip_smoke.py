#!/usr/bin/env python3
"""On-device smoke run of the PyTorch/CUDA port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and nothing else: no flags, no network, no
weights on disk (they are drawn from a seed). It exits non-zero as soon as
any phase fails and never carries on on the CPU. Phases, each printing one
JSON line:

  env      the card (name, power limit), torch / CUDA / nvcc versions
  build    builds ``src/repro_torch/kernels/csrc/*.cu`` and loads the library
  kernels  every kernel against its plain PyTorch version at the main path's
           shapes and at edge shapes, with times: ``ms`` is device time (the
           calls replayed from a CUDA graph between two CUDA events, so the
           host's launch path is left out), ``eager_ms`` the same calls
           made one by one from Python (what an eager caller waits for)
  model    full-width smollm-360m: prefill forward (flash-attention kernel)
           against token-by-token decode (flash-decode kernel) and against
           the same model on its plain attention, in bf16 at full depth and
           in fp32 at cut depth
  serve    the main path: Cluster -> DataPlane -> WorkerDaemon -> LiveBackend
           -> ContinuousBatcher -> DecoderLM.decode_step at full width,
           16 requests, with the launch counters accounting for every step

then one ``{"kernels": [...]}`` line (per kernel: launches on the main path,
error, time, plain time, library time, bound), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.

Tolerances. A kernel against its plain version on the same inputs: 2e-5 in
fp32 (both accumulate in fp32; only the summation order differs) and 2e-2 in
bf16 (one bf16 rounding of an output of magnitude <= ~4). fp32 comparisons
run with TF32 switched off. Model-level tolerances are stated where they are
applied.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

SEED = 1234
N_REQUESTS = 16
MAX_NEW = 32
MAX_SEQ = 1024
MAX_SLOTS = 8


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n_inner: int = 1, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of one call inside ``fn`` (``fn`` makes ``n_inner``
    calls), measured with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_inner)


def device_ms(fn, n_inner: int = 1, reps: int = 20) -> float:
    """Mean milliseconds of device time of one call inside ``fn``: the calls
    are captured once into a CUDA graph and the graph is replayed, so the
    host's launch path (Python, the allocator, the launch call) is left out
    and what is timed is the kernels alone, back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, n_inner, reps=reps, warmup=2)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase: env -----------------------------------------------------------------

def phase_env() -> str:
    from repro_torch.kernels import build

    gpu = gpu_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    require(nvcc.returncode == 0, "nvcc --version failed")
    emit("env", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0))
    return gpu


# -- phase: build ---------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load(verbose_ptxas=True)
    wall = time.perf_counter() - t0
    # registers / spills of each kernel instantiation, from ptxas -v
    usage = []
    for m in re.finditer(
            r"Compiling entry function '\w*?\d+([a-z_]+_kernel)I(\w+?)E+v\w*'"
            r".*?(\d+) bytes spill stores.*?Used (\d+) registers",
            build.build_log, re.S):
        usage.append({"fn": f"{m.group(1)}<{m.group(2)}>",
                      "spill_bytes": int(m.group(3)),
                      "registers": int(m.group(4))})
    emit("build", seconds=round(wall, 3),
         nvcc_seconds=None if build.build_seconds is None
         else round(build.build_seconds, 3),
         flags=" ".join(build.NVCC_FLAGS), kernels=usage)


# -- phase: kernels -------------------------------------------------------------

def decode_inputs(B, Smax, Hq, Hkv, D, dtype, lens, n_layers, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((n_layers, B, 1, Hq, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    kc = torch.randn((n_layers, B, Smax, Hkv, D), generator=g, device="cuda",
                     dtype=torch.float32).to(dtype)
    vc = torch.randn((n_layers, B, Smax, Hkv, D), generator=g, device="cuda",
                     dtype=torch.float32).to(dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kc, vc, lens_t


def sdpa_decode(q, kc, vc, mask):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).transpose(1, 2)


def check_decode(name, B, Smax, Hq, Hkv, D, dtype, lens, timed=False,
                 scalar_len=None):
    """Kernel vs plain on one decode shape. With ``timed`` the calls walk
    ``n_layers`` distinct caches (335 MB at the main path's shape), as one
    decode step of the model does, so that every launch finds its K and V
    cold in L2 as the real caller does."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    n_layers = 32 if timed else 1
    q, kc, vc, lens_t = decode_inputs(B, Smax, Hq, Hkv, D, dtype, lens,
                                      n_layers, seed=SEED)
    arg = lens_t if scalar_len is None else scalar_len
    got = decode_attention(q[0], kc[0], vc[0], arg)
    want = decode_attention_plain(q[0], kc[0], vc[0], arg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    rec = {"case": name, "kernel": "decode_attention",
           "shape": {"B": B, "Smax": Smax, "Hq": Hq, "Hkv": Hkv, "D": D},
           "dtype": str(dtype).replace("torch.", ""),
           "lens": lens if scalar_len is None else scalar_len,
           "max_abs_err": err, "tol": KERNEL_TOL[dtype]}
    require(bool(torch.isfinite(got.float()).all()), f"{name}: not finite")
    require(err <= KERNEL_TOL[dtype],
            f"{name}: max_abs_err {err} > {KERNEL_TOL[dtype]}")
    if timed:
        item = q.element_size()
        live = sum(min(max(int(n), 0), Smax) for n in lens)
        nbytes = (2 * live * Hkv * D + 2 * B * Hq * D) * item + 4 * B
        flops = 4.0 * live * Hq * D
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / PEAK_FLOPS[dtype] * 1e3
        mask = (torch.arange(Smax, device="cuda")[None, :]
                < lens_t[:, None])[:, None, None, :]

        def run_kernel():
            for i in range(n_layers):
                decode_attention(q[i], kc[i], vc[i], lens_t)

        def run_plain():
            for i in range(n_layers):
                decode_attention_plain(q[i], kc[i], vc[i], lens_t)

        def run_library():
            for i in range(n_layers):
                sdpa_decode(q[i], kc[i], vc[i], mask)

        lib_err = max_abs_err(sdpa_decode(q[0], kc[0], vc[0], mask), want)
        rec.update(
            ms=device_ms(run_kernel, n_layers),
            plain_ms=device_ms(run_plain, n_layers, reps=5),
            library_ms=device_ms(run_library, n_layers),
            eager_ms=time_ms(run_kernel, n_layers),
            eager_plain_ms=time_ms(run_plain, n_layers, reps=5, warmup=1),
            eager_library_ms=time_ms(run_library, n_layers),
            library_max_abs_err=lib_err,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes=nbytes, flops=flops)
        rec["ms_again"] = device_ms(run_kernel, n_layers)
    return rec


def flash_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    v = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda",
                    dtype=torch.float32).to(dtype)
    return q, k, v


def visible_pairs(Sq, Skv, causal, q_offset) -> int:
    if not causal:
        return Sq * Skv
    return sum(min(Skv, i + q_offset + 1) for i in range(Sq))


def check_flash(name, B, Sq, Skv, Hq, Hkv, D, dtype, causal, q_offset=0,
                timed=False):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    q, k, v = flash_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed=SEED + 1)
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    rec = {"case": name, "kernel": "flash_attention",
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq, "Hkv": Hkv,
                     "D": D},
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "q_offset": q_offset, "max_abs_err": err,
           "tol": KERNEL_TOL[dtype]}
    require(bool(torch.isfinite(got.float()).all()), f"{name}: not finite")
    require(err <= KERNEL_TOL[dtype],
            f"{name}: max_abs_err {err} > {KERNEL_TOL[dtype]}")
    if timed:
        item = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item
        flops = 4.0 * D * Hq * B * visible_pairs(Sq, Skv, causal, q_offset)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / PEAK_FLOPS[dtype] * 1e3
        def run_kernel():
            return flash_attention(q, k, v, causal=causal, q_offset=q_offset)

        def run_plain():
            return flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)

        rec.update(
            ms=device_ms(run_kernel), plain_ms=device_ms(run_plain, reps=5),
            eager_ms=time_ms(run_kernel),
            eager_plain_ms=time_ms(run_plain, reps=5, warmup=1),
            library_ms=None, bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes=nbytes, flops=flops)
        if Sq == Skv and q_offset == 0:
            def run_library():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True).transpose(1, 2)
            rec["library_max_abs_err"] = max_abs_err(run_library(), want)
            rec["library_ms"] = device_ms(run_library)
            rec["eager_library_ms"] = time_ms(run_library)
        rec["ms_again"] = device_ms(run_kernel)
    return rec


def phase_kernels() -> dict:
    """Returns the timed main-path records, by kernel name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    ragged = [1, 1024, 37, 512, 700, 64, 999, 250]
    cases = [
        # K1 at the main path's shape: one ContinuousBatcher step of
        # smollm-360m, 8 slots, 1024-long cache, per-slot lengths
        check_decode("decode/main/bf16", 8, 1024, 15, 5, 64, bf16, ragged,
                     timed=True),
        check_decode("decode/main/fp32", 8, 1024, 15, 5, 64, f32, ragged,
                     timed=True),
        check_decode("decode/scalar-len", 8, 1024, 15, 5, 64, bf16,
                     [333] * 8, scalar_len=333),
        check_decode("decode/len0-row", 4, 256, 15, 5, 64, f32,
                     [0, 1, 255, 256]),
        check_decode("decode/mha-d32", 2, 300, 4, 4, 32, f32, [300, 17]),
        check_decode("decode/g16-d128", 2, 512, 32, 2, 128, bf16, [512, 129]),
        check_decode("decode/mqa48-d128", 1, 640, 48, 1, 128, f32, [601]),
        # K2 at the main path's shape (the 256-token prefill of the model
        # phase) and at the sizes named for it
        check_flash("flash/main/bf16", 1, 256, 256, 15, 5, 64, bf16, True,
                    timed=True),
        check_flash("flash/S512/bf16", 2, 512, 512, 15, 5, 64, bf16, True,
                    timed=True),
        check_flash("flash/S512/fp32", 2, 512, 512, 15, 5, 64, f32, True,
                    timed=True),
        check_flash("flash/S512/noncausal", 2, 512, 512, 15, 5, 64, bf16,
                    False, timed=True),
        check_flash("flash/ragged333/causal", 2, 333, 333, 15, 5, 64, f32,
                    True),
        check_flash("flash/ragged333/noncausal", 2, 333, 333, 15, 5, 64, bf16,
                    False),
        check_flash("flash/q_offset", 2, 100, 333, 15, 5, 64, f32, True,
                    q_offset=233),
        check_flash("flash/q_offset-short", 1, 70, 200, 6, 2, 32, f32, True,
                    q_offset=17),
        check_flash("flash/mqa-d128", 1, 130, 130, 8, 1, 128, bf16, True),
    ]
    emit("kernels", cases=cases)
    return {"decode_attention": cases[0], "flash_attention": cases[7]}


# -- phase: model ---------------------------------------------------------------

def prefill_vs_decode(cfg, run_kernel, run_plain, prompt_len, tol, label):
    """forward (flash-attention kernel) vs the same prompt fed token by
    token through decode_step (flash-decode kernel) vs the same weights on
    the plain attention; last-position logits."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import build_model

    model = build_model(cfg, run_kernel, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    plain = build_model(cfg, run_plain, device="cuda")
    plain.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (1, prompt_len), generator=g,
                         dtype=torch.int32).cuda()
    with torch.inference_mode():
        t0 = time.perf_counter()
        fwd = model.forward({"tokens": toks})[:, -1].float()
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd_plain = plain.forward({"tokens": toks})[:, -1].float()
        cache = model.init_cache(ShapeSpec("m", MAX_SEQ, 1, "decode"))
        cache_p = plain.init_cache(ShapeSpec("m", MAX_SEQ, 1, "decode"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(prompt_len):
            dec, cache = model.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "cache_len": t})
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        for t in range(prompt_len):
            dec_plain, cache_p = plain.decode_step(
                cache_p, {"tokens": toks[:, t:t + 1], "cache_len": t})
        dec, dec_plain = dec.float(), dec_plain.float()
    rec = {
        "leg": label, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
        "prompt_len": prompt_len, "tol": tol,
        "logit_std": float(fwd_plain.std()),
        "forward_kernel_vs_decode_kernel": max_abs_err(fwd, dec),
        "forward_kernel_vs_forward_plain": max_abs_err(fwd, fwd_plain),
        "decode_kernel_vs_decode_plain": max_abs_err(dec, dec_plain),
        "forward_plain_vs_decode_plain": max_abs_err(fwd_plain, dec_plain),
        "argmax_agree": bool(fwd.argmax(-1).equal(dec.argmax(-1))
                             and fwd.argmax(-1).equal(fwd_plain.argmax(-1))),
        "forward_seconds": round(fwd_s, 4),
        "decode_ms_per_step": round(dec_s / prompt_len * 1e3, 4),
    }
    for t in (fwd, dec, fwd_plain, dec_plain):
        require(t.shape == (1, cfg.vocab), f"{label}: logits shape {t.shape}")
        require(bool(torch.isfinite(t).all()), f"{label}: logits not finite")
    for key in ("forward_kernel_vs_decode_kernel",
                "forward_kernel_vs_forward_plain",
                "decode_kernel_vs_decode_plain"):
        require(rec[key] <= tol, f"{label}: {key} = {rec[key]} > {tol}")
    del model, plain, cache, cache_p
    torch.cuda.empty_cache()
    return rec


def phase_model(cfg) -> None:
    from dataclasses import replace

    from repro_torch.models.api import RunConfig

    run_kernel = RunConfig(attn_impl="kernel")
    run_plain = RunConfig(attn_impl="plain")
    # fp32 at full width, depth cut to 4: the two kernels, the cache writes
    # and the positions must agree with the plain path to fp32 round-off.
    # Tolerance 2e-3 on logits of unit scale: the seed's weight scale makes
    # softmax rows sharply peaked, which amplifies 1e-6 round-off per layer.
    legs = [prefill_vs_decode(
        replace(cfg, n_layers=4, dtype="float32"), run_kernel, run_plain,
        prompt_len=256, tol=2e-3, label="fp32-depth4")]
    # bf16 at full depth: every op rounds to 8 bits of mantissa and the two
    # paths round at different places, so only a loose bound can be stated:
    # 0.5 on logits whose standard deviation is printed beside it.
    legs.append(prefill_vs_decode(cfg, run_kernel, run_plain, prompt_len=256,
                                  tol=0.5, label="bf16-full"))
    emit("model", config=cfg.name, legs=legs)


# -- phase: serve ---------------------------------------------------------------

def profile_decode_steps(cfg, cache, prompts, n_steps: int = 8) -> dict:
    """Steady state of one replica with every slot busy: wall time per
    lockstep decode step, and from ``torch.profiler`` the share of that wall
    time during which the device ran a kernel, with the kernels that took
    most of it. Device numbers are None when the profiler saw no device
    activity (they are then not measured, not zero)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ContinuousBatcher, Replica

    rep = Replica(cfg, rng_seed=0, max_seq=MAX_SEQ, exec_cache=cache)
    cb = ContinuousBatcher(rep, max_slots=MAX_SLOTS)
    for p in prompts[:MAX_SLOTS]:
        cb.add_request(p, max_new=MAX_NEW)
    for _ in range(4):
        cb.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        cb.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            cb.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / n_steps * 1e3
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    out = {"slots_busy": MAX_SLOTS, "steps": n_steps,
           "ms_per_step": step_ms, "ms_per_step_traced": traced_ms,
           "tokens_per_s": MAX_SLOTS / step_ms * 1e3,
           "device_busy_ms_per_step": None, "device_busy_share": None,
           "top_device_kernels": None}
    if busy_us > 0:
        out.update(
            device_busy_ms_per_step=busy_us / n_steps / 1e3,
            device_busy_share=busy_us / n_steps / 1e3 / traced_ms,
            device_launches_per_step=sum(r[2] for r in rows) / n_steps,
            top_device_kernels=[
                {"name": k[:60], "ms_per_step": us / n_steps / 1e3,
                 "launches_per_step": n / n_steps} for k, us, n in rows[:8]])
    return out


def phase_serve(cfg) -> None:
    import numpy as np

    from repro_torch.core import Cluster, Function, ScalingConfig
    from repro_torch.core.request import LiveRequest
    from repro_torch.kernels import ops
    from repro_torch.live import LiveBackend, LiveFunctionSpec
    from repro_torch.serving.engine import Replica
    from repro_torch.serving.exec_cache import ExecutableCache
    from repro_torch.simcore import Environment

    class CountingBackend(LiveBackend):
        """Remembers which sandbox served which request and how many decode
        steps every sandbox's batcher took, teardowns included."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sandbox_of = {}
            self.retired_steps = 0

        def admit(self, sandbox_id, req):
            self.sandbox_of[id(req)] = sandbox_id
            return super().admit(sandbox_id, req)

        def teardown_hook(self, sandbox_id, drain=True):
            rt = self.sandboxes.get(sandbox_id)
            super().teardown_hook(sandbox_id, drain)
            if rt is not None:
                self.retired_steps += rt.batcher.steps

        def decode_steps(self):
            return self.retired_steps + sum(
                rt.batcher.steps for rt in self.sandboxes.values())

    cache = ExecutableCache()
    spec = LiveFunctionSpec(cfg=cfg, max_seq=MAX_SEQ, max_slots=MAX_SLOTS)
    lb = CountingBackend(default_spec=spec, exec_cache=cache)
    env = Environment(seed=7)
    cluster = Cluster(env, n_workers=4, runtime="firecracker",
                      live_backend=lb, sandbox_concurrency=MAX_SLOTS)
    cluster.start()
    cluster.register_sync(Function(
        name="llm", image_url="registry://smollm-360m", port=9000,
        scaling=ScalingConfig(target_concurrency=MAX_SLOTS)))

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist()
               for _ in range(N_REQUESTS)]
    k1_before = ops.launch_counts()["decode_attention"]
    warmed_before = cache.compiled_executables()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    invs = [cluster.invoke("llm", exec_time=0.05, request=LiveRequest(
        prompt=p, max_new_tokens=MAX_NEW)) for p in prompts]
    env.run(until=env.now + 120.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    served = [i for i in invs if i.t_done > 0 and not i.failed]
    require(len(served) == N_REQUESTS,
            f"served {len(served)}/{N_REQUESTS}: "
            f"{[i.failure_reason for i in invs if i.failed]}")
    for i in invs:
        toks = i.request.tokens
        require(toks is not None and len(toks) == MAX_NEW,
                f"request {i.inv_id}: tokens {toks}")
        require(all(0 <= t < cfg.vocab for t in toks), "token id out of range")
    require(lb.batched_invokes > 0, "no invocation shared a decode step")

    steps = lb.decode_steps()
    warmed = cache.compiled_executables() - warmed_before
    k1 = ops.launch_counts()["decode_attention"] - k1_before
    require(k1 == (steps + warmed) * cfg.n_layers,
            f"decode kernel launches {k1} != (steps {steps} + warm-up steps "
            f"{warmed}) x layers {cfg.n_layers}")

    # one request against a fresh replica with its sandbox's seed: the same
    # weights, alone in a batch of one, must give the same greedy tokens
    probe = invs[0]
    sid = lb.sandbox_of[id(probe.request)]
    solo = Replica(cfg, rng_seed=sid, max_seq=MAX_SEQ, run_cfg=spec.run_cfg,
                   exec_cache=cache).generate(prompts[0],
                                              max_new_tokens=MAX_NEW)
    same = sum(int(a == b) for a, b in zip(solo, probe.request.tokens))
    require(solo == probe.request.tokens,
            f"batched tokens differ from a solo replica's ({same}/{MAX_NEW} "
            f"equal): {probe.request.tokens} vs {solo}")

    profile = profile_decode_steps(cfg, cache, prompts)

    walls = sorted(i.request.wall_s for i in invs)
    colds = [r["wall_s"] for r in lb.start_log if r["cold"]]
    warms = [r["wall_s"] for r in lb.start_log if not r["cold"]]
    stats = lb.cache_stats()
    lb.close()
    require(lb.replicas_live == 0, "replicas left after close()")
    emit("serve", config=cfg.name, requests=N_REQUESTS, served=len(served),
         max_new_tokens=MAX_NEW, prompt_lens=[len(p) for p in prompts],
         replicas_created=len(lb.start_log),
         create_cold_s=colds, create_warm_s=warms,
         invoke_wall_p50_s=walls[len(walls) // 2],
         invoke_wall_p99_s=walls[min(len(walls) - 1,
                                     math.ceil(0.99 * len(walls)) - 1)],
         invoke_seconds_total=lb.invoke_seconds_total,
         tokens_total=lb.tokens_total,
         tokens_per_s=lb.tokens_total / wall, wall_s=wall,
         decode_steps=steps, warm_steps=warmed,
         ms_per_decode_step=lb.invoke_seconds_total / max(steps, 1) * 1e3,
         batched_invokes=lb.batched_invokes,
         decode_kernel_launches=k1, teardowns=lb.teardowns,
         exec_cache=stats, steady_state=profile,
         peak_memory_bytes=torch.cuda.max_memory_allocated())


# -- main -----------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    gpu = phase_env()
    phase_build()
    timed = phase_kernels()

    cfg = get_config("smollm-360m")          # full width, full depth, bf16
    # the main path starts here: the counters are zeroed just before it and
    # read just after it, so the comparisons above do not count
    ops.reset_launch_counts()
    phase_model(cfg)
    phase_serve(cfg)
    launches = ops.launch_counts()

    sources = {
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:82"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:102"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        rec = timed[name]
        require(launches[name] > 0,
                f"{name}: the main path never launched the kernel")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
