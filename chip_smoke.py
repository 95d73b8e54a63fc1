#!/usr/bin/env python3
"""On-device smoke run of the PyTorch/CUDA port (one NVIDIA Hopper GPU).

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` and nothing else: no flags, no network, no
weights on disk (they are drawn from a seed). It exits non-zero as soon as
any phase fails and never carries on on the CPU. Phases, each printing one
JSON line:

  env      the card (name, power limit), torch / CUDA / nvcc versions
  build    builds ``src/repro_torch/kernels/csrc/*.cu`` and loads the library
  kernels  every kernel against its plain PyTorch version at the main paths'
           shapes and at edge shapes, with times: ``ms`` is device time (the
           calls replayed from a CUDA graph between two CUDA events, so the
           host's launch path is left out; a graph holds 32 decode layers or
           8 prefill calls, so one graph launch is spread over them),
           ``eager_ms`` the same calls made one by one from Python (what an
           eager caller waits for), and for flash attention
           ``profiled_ms``, the device time ``torch.profiler`` records for a
           call; flash-decode's split of the KV axis is checked at other
           plans, on zero-length rows, and eager against graph replay; the
           recurrences (WKV6, SSD), whose products run on the tensor cores
           as 3xTF32, are checked where the split's error is largest (every
           log w at the clamp, factors up to e^32), at chunks of 32 and 16
           (the mma tiles' edges), in bf16 at full width, and eager against
           graph replay (bit-equal), and from inputs that are not 16-byte
           aligned (element copies); their rows carry the bound of the
           arithmetic they run (three TF32 products at 495 TFLOP/s) beside
           the fp32 one, and ``ms`` three times (``ms``, ``ms_again``,
           ``ms_third``) for the spread
  designs  the recurrence kernels' other block shapes (``design`` of the
           wrappers) at the main paths' shapes, timed in turns

then ten paths, each driven with the launch counters zeroed just before
it and read just after it:

  smollm-360m  model: full-width prefill forward (flash-attention kernel)
               against token-by-token decode (flash-decode kernel) and
               against the same model on its plain attention, bf16 at full
               depth and fp32 at cut depth; serve: Cluster -> DataPlane ->
               WorkerDaemon -> LiveBackend -> ContinuousBatcher ->
               DecoderLM.decode_step, 16 requests, the launch counters
               accounting for every step
  rwkv6-7b     model: the same legs at full width (forward on the WKV6
               kernel); serve: the same path and traffic into
               RWKV6Model.decode_step, plus one probe request admitted into
               a slot that has served before, whose tokens must equal a solo
               Replica.generate on its sandbox's weights
  zamba2-2.7b  model: the same legs at full width (forward on the SSD and
               flash-attention kernels at head_dim 80, decode on the
               flash-decode kernel), the Mamba matrices drawn at their
               per-layer fan-in; generate: Replica.generate twice on the
               same weights, equal greedy tokens
  arctic-480b  the MoE family (128 experts, top-2, dense residual) at full
               width, depth cut to what 80 GB holds (printed in each line):
               model legs (bf16 at depth 2, fp32 at depth 1) on K2 and K1 at
               head_dim 128 with 56/8 heads, the plain twin sharing the
               kernel model's tensors; serve: the smollm traffic through the
               same path into one replica at a time (max_scale 1), the probe
               against a solo replica built after the backend is gone
  qwen2-vl-72b the vlm family (M-RoPE, text-only positions) at full width:
               model legs, bf16 at depth 8 and fp32 at depth 2
  smollm-360m/container
               the smollm traffic with LiveBackend(mode="container"): one
               worker process per sandbox, the kernel library built into a
               fresh build directory by the first (cold) creation and loaded
               by the later (warm) ones; every request's tokens against an
               in-process replica with its sandbox's seed, which runs (and
               counts) the flash-decode kernel
  whisper-small
               the audio family at full width and depth (12 + 12 layers,
               1500 frames drawn on the card, batch 2, weights at the
               per-layer fan-in; the reference's init recorded), fp32 and
               bf16:
               encode and forward on the kernels (flash attention
               non-causal over the frames, causal over the tokens, cross
               attention with Sq != Skv) against the plain forms;
               prefill_cross, 4 prompt and 32 greedy tokens through
               decode_step (flash-decode against the self cache and the
               1500-long cross cache), their logits against forward's at
               every position
  train/smollm-360m
               the training launcher's step (plain attention forms, AdamW,
               ZipfLMStream) at full width and depth in bf16: 20 steps, the
               loss must fall; a checkpoint saved and restored on the CPU
               bit for bit; every kernel wrapper handed a grad-requiring
               CUDA input must refuse it; grad accumulation against one
               step at fp32 depth 4 (on per-layer fan-in weights; the
               reference's init recorded beside). Its kernel counters must
               read 0
  train/whisper-small
               one train step at full width (bf16): finite loss, grad norm
               above 0, parameters moved; its kernel counters must read 0
  launch/serve the serve launcher (24 requests, 4 workers, the reduced
               model) at 40 requests a virtual second: every request ok,
               each one's tokens equal to a solo replica of the sandbox it
               was admitted to

then one ``{"kernels": [...]}`` line (per kernel: launches on the paths,
error, time, plain time, library time, bound; for WKV6 and SSD also the
3xTF32 bound), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

Tolerances. A kernel against its plain version on the same inputs: 2e-5 in
fp32 (both accumulate in fp32; only the summation order differs) and 2e-2 in
bf16 (one bf16 rounding of an output of magnitude <= ~4); the recurrences
(WKV6, SSD) five times that, as an allclose (atol = rtol), the limits of
tests/test_kernels.py: their chunked form multiplies factors exp(+-cum) of
up to e^32 whose fp32 prefix sums differ by a few ulp between the two
summation orders, and the kernels' 3xTF32 products drop ~2^-21 of each
product (tests/test_torch_recurrence_designs.py models the split). fp32
comparisons run with TF32 switched off in PyTorch. The SSD at
the reference init's scale and the model-level tolerances are stated where
they are applied.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12   # the tensor cores in TF32; a 3xTF32 product is 3 of them
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RECURRENCE_TOL = {dt: 5 * tol for dt, tol in KERNEL_TOL.items()}

SEED = 1234
FLASH_CALLS = 8      # K2 calls per timed CUDA graph
# the block shapes of K4 and K3 timed in turns (``design`` of the wrappers;
# 0 is the launcher's own choice, csrc/ssd_chunk.cu and rwkv6_chunk.cu
# list the others)
SSD_DESIGNS = (0, 1, 2, 3, 4)
WKV6_DESIGNS = (0, 1, 2)
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


def profiled_ms(fn, calls: int = 10) -> Optional[float]:
    """Milliseconds of device time a call of ``fn`` keeps the card busy,
    summed over its kernels as ``torch.profiler`` records them (no launch
    gaps); None if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) or 0
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else None


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
            r"Compiling entry function '\w*?\d+([a-z][a-z0-9_]*_kernel)I(\w+?)E+v\w*'"
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

def bound(nbytes, flops, peak):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def bound_3xtf32(nbytes, product_flops):
    """The bound of the arithmetic the recurrence kernels run: their
    products as three TF32 products each on the tensor cores, against the
    bytes."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 3 * product_flops / TF32_FLOPS * 1e3
    return {"bound_3xtf32_ms": max(by_bytes, by_ops),
            "bound_3xtf32_by": "bytes" if by_bytes >= by_ops
            else "operations"}


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
                 scalar_len=None, split=None, plans=()):
    """Kernel vs plain on one decode shape. With ``timed`` the calls walk
    ``n_layers`` distinct caches (335 MB at the main path's shape), as one
    decode step of the model does, so that every launch finds its K and V
    cold in L2 as the real caller does. ``split`` requires the planner to
    split the KV range (True) or not (False); ``plans`` are other
    ``(nsplit, chunk)`` to time beside the planner's."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      split_plan)

    n_layers = 32 if timed else 1
    q, kc, vc, lens_t = decode_inputs(B, Smax, Hq, Hkv, D, dtype, lens,
                                      n_layers, seed=SEED)
    arg = lens_t if scalar_len is None else scalar_len
    got = decode_attention(q[0], kc[0], vc[0], arg)
    want = decode_attention_plain(q[0], kc[0], vc[0], arg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    plan = split_plan(B, Hq, Hkv, Smax,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {"case": name, "kernel": "decode_attention",
           "shape": {"B": B, "Smax": Smax, "Hq": Hq, "Hkv": Hkv, "D": D},
           "dtype": str(dtype).replace("torch.", ""),
           "lens": lens if scalar_len is None else scalar_len,
           "plan": plan, "max_abs_err": err, "tol": KERNEL_TOL[dtype]}
    require(bool(torch.isfinite(got.float()).all()), f"{name}: not finite")
    require(err <= KERNEL_TOL[dtype],
            f"{name}: max_abs_err {err} > {KERNEL_TOL[dtype]}")
    if split is not None:
        require((plan[0] > 1) == split, f"{name}: plan {plan}")
    for alt in plans:
        alt_err = max_abs_err(decode_attention(q[0], kc[0], vc[0], arg,
                                               plan=alt), want)
        require(alt_err <= KERNEL_TOL[dtype],
                f"{name}: plan {alt}: max_abs_err {alt_err}")
    if timed:
        item = q.element_size()
        live = sum(min(max(int(n), 0), Smax) for n in lens)
        nbytes = (2 * live * Hkv * D + 2 * B * Hq * D) * item + 4 * B
        flops = 4.0 * live * Hq * D
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
            library_max_abs_err=lib_err, **bound(nbytes, flops,
                                                 PEAK_FLOPS[dtype]))
        rec["ms_again"] = device_ms(run_kernel, n_layers)
        rec["plan_ms"] = {}
        for alt in plans:
            def run_alt(alt=alt):
                for i in range(n_layers):
                    decode_attention(q[i], kc[i], vc[i], lens_t, plan=alt)
            rec["plan_ms"]["x".join(map(str, alt))] = device_ms(run_alt,
                                                                n_layers)
    return rec


def check_decode_graph(name, B, Smax, Hq, Hkv, D, dtype, lens):
    """One split call made twice eagerly, then captured into one CUDA graph
    and replayed twice: the four outputs must be bit-equal (each launch
    leaves the split counters at 0 for the next)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      split_plan)

    plan = split_plan(B, Hq, Hkv, Smax,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    require(plan[0] > 1, f"{name}: plan {plan} does not split")
    q, kc, vc, lens_t = decode_inputs(B, Smax, Hq, Hkv, D, dtype, lens, 1,
                                      seed=SEED + 6)
    q, kc, vc = q[0], kc[0], vc[0]
    outs = [decode_attention(q, kc, vc, lens_t).clone() for _ in range(2)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = decode_attention(q, kc, vc, lens_t)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(static.clone())
    equal = [bool(torch.equal(outs[0], o)) for o in outs]
    err = max_abs_err(outs[0], decode_attention_plain(q, kc, vc, lens_t))
    rec = {"case": name, "kernel": "decode_attention",
           "shape": {"B": B, "Smax": Smax, "Hq": Hq, "Hkv": Hkv, "D": D},
           "dtype": str(dtype).replace("torch.", ""), "lens": lens,
           "plan": plan, "eager_eager_graph_graph_bit_equal": equal,
           "max_abs_err": err, "tol": KERNEL_TOL[dtype]}
    require(all(equal), f"{name}: outputs differ: {equal}")
    require(err <= KERNEL_TOL[dtype], f"{name}: max_abs_err {err}")
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
    """Kernel vs plain on one prefill shape. Timed: ``ms`` and
    ``library_ms`` from FLASH_CALLS calls a graph, ``profiled_ms`` and
    ``library_profiled_ms`` the device time ``torch.profiler`` records for
    one call."""
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

        # FLASH_CALLS calls a graph, so that one graph launch is spread
        # over them (K1's cases spread it over their 32 layers); the time
        # from a graph of one call is kept beside it
        def calls(fn, n=FLASH_CALLS):
            def run():
                for _ in range(n):
                    fn()
            return run

        def one_kernel():
            return flash_attention(q, k, v, causal=causal, q_offset=q_offset)

        def one_plain():
            return flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)

        def one_library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True).transpose(1, 2)

        rec.update(
            ms=device_ms(calls(one_kernel), FLASH_CALLS),
            plain_ms=device_ms(calls(one_plain), FLASH_CALLS, reps=5),
            eager_ms=time_ms(one_kernel),
            eager_plain_ms=time_ms(one_plain, reps=5, warmup=1),
            ms_one_call_graph=device_ms(one_kernel),
            library_ms=None, **bound(nbytes, flops, PEAK_FLOPS[dtype]))
        # SDPA's causal mask is aligned top-left, the kernel's to the
        # diagonal at q_offset: only a non-causal call or a square causal
        # one computes the same function
        if q_offset == 0 and (not causal or Sq == Skv):
            rec["library_max_abs_err"] = max_abs_err(one_library(), want)
            rec["library_ms"] = device_ms(calls(one_library), FLASH_CALLS)
            rec["library_ms_one_call_graph"] = device_ms(one_library)
            rec["library_profiled_ms"] = profiled_ms(one_library)
            rec["eager_library_ms"] = time_ms(one_library)
        rec["ms_again"] = device_ms(calls(one_kernel), FLASH_CALLS)
        rec["profiled_ms"] = profiled_ms(one_kernel)
    return rec


def allclose_excess(got, want, tol) -> float:
    """max(|got - want| - tol * |want|): <= tol is an allclose with
    atol = rtol = tol, the recurrences' criterion (tests/test_kernels.py)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - tol * want.abs()).max())


def wkv6_inputs(B, S, H, dk, dv, dtype, seed, strong_decay=False):
    """The distributions of tests/test_kernels.py, drawn on the card. With
    ``strong_decay`` every log w sits at the models' clamp (-0.5), so that
    over a chunk of 64 the factors exp(+-cum) reach e^32, where the 3xTF32
    split's error is largest."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (n(B, S, H, d) * 0.5 for d in (dk, dk, dv))
    w = torch.exp(-torch.exp(n(B, S, H, dk) * 0.5 - 1.5)).clamp(0.62, 0.9999)
    if strong_decay:
        w = torch.full_like(w, math.exp(-0.5))
    u = n(H, dk) * 0.3
    s0 = n(B, H, dk, dv) * 0.1
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


def misalign(t):
    """The same values in a contiguous view that starts one element past an
    aligned address: the recurrence kernels then copy their inputs element
    by element instead of 16 bytes at a time."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_wkv6(name, B, S, H, dk, dv, chunk, dtype, state=True, timed=False,
               strong_decay=False, misaligned=False):
    """K3 against its plain version (the chunked form): y and the final
    state. ``state=False`` passes zeros, as the model's forward does."""
    from repro_torch.kernels.rwkv6_chunk import wkv6, wkv6_plain

    r, k, v, w, u, s0 = wkv6_inputs(B, S, H, dk, dv, dtype, SEED + 3,
                                    strong_decay)
    if misaligned:
        r, k, v, w = (misalign(t) for t in (r, k, v, w))
    if not state:
        s0 = torch.zeros_like(s0)
    tol = RECURRENCE_TOL[dtype]
    got = wkv6(r, k, v, w, u, s0, chunk=chunk)
    want = wkv6_plain(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    rec = {"case": name, "kernel": "wkv6",
           "shape": {"B": B, "S": S, "H": H, "dk": dk, "dv": dv,
                     "chunk": chunk},
           "dtype": str(dtype).replace("torch.", ""), "initial_state": state,
           "strong_decay": strong_decay, "misaligned": misaligned,
           "max_abs_err": max_abs_err(got[0], want[0]),
           "state_max_abs_err": max_abs_err(got[1], want[1]),
           "allclose_excess": max(allclose_excess(a, b, tol)
                                  for a, b in zip(got, want)),
           "tol": tol}
    for t in got:
        require(bool(torch.isfinite(t).all()), f"{name}: not finite")
    require(rec["allclose_excess"] <= tol,
            f"{name}: outside allclose(atol=rtol={tol}): {rec}")
    if timed:
        item = r.element_size()
        n_chunks = S // chunk
        nbytes = (B * S * H * (2 * dk + dv) * item     # r, k, v
                  + B * S * H * dk * 4 + H * dk * 4     # w, u
                  + 2 * B * H * dk * dv * 4             # state in and out
                  + B * S * H * dv * 4)                 # y
        products = (2 * dk * chunk * (chunk - 1) // 2   # strictly-lower scores
                    + 2 * dv * chunk * (chunk + 1) // 2  # scores @ v
                    + 4 * chunk * dk * dv)               # q_dec @ S, carry
        per_chunk = (products
                     + 2 * dk * chunk                   # the u bonus
                     + dk * dv)                         # the state's decay
        flops = float(B * H * n_chunks * per_chunk)

        def run_kernel():
            return wkv6(r, k, v, w, u, s0, chunk=chunk)

        def run_plain():
            return wkv6_plain(r, k, v, w, u, s0, chunk=chunk)

        rec.update(bound(nbytes, flops, PEAK_FLOPS[dtype]))
        rec.update(bound_3xtf32(nbytes, float(B * H * n_chunks * products)))
        rec.update(ms=device_ms(run_kernel), plain_ms=device_ms(run_plain,
                                                                reps=5),
                   eager_ms=time_ms(run_kernel),
                   eager_plain_ms=time_ms(run_plain, reps=5, warmup=1),
                   library_ms=None,
                   library_note="no PyTorch call computes WKV6")
        rec["ms_again"] = device_ms(run_kernel)
        rec["ms_third"] = device_ms(run_kernel)
    return rec


def ssd_inputs(b, S, H, P, N, dtype, broadcast, seed, init_scale=False):
    """The distributions of tests/test_kernels.py; with ``broadcast`` B and
    C are one (b, S, N) tensor viewed over the heads (head stride 0) and x
    a strided view, as Zamba2Model passes them. ``init_scale`` draws what
    zamba2-2.7b's mixers see under the reference's init instead: in_proj
    outputs of std ~17 (fan-in n_super = 9 over d_model 2560), so dt =
    softplus(N(0, 17)) and x, B, C = silu of their width-4 conv (std ~6.8),
    with A = -linspace(1, 8, H)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    if init_scale:
        dt = F.softplus(n(b, S, H) * 17.0)
        A = -torch.linspace(1.0, 8.0, H, device="cuda")

        def act(*shape):
            return F.silu(n(*shape) * 6.8)
    else:
        dt = F.softplus(n(b, S, H) * 0.5) * 0.5
        A = -torch.exp(n(H) * 0.3)

        def act(*shape):
            return n(*shape) * 0.5
    D = n(H) * 0.3
    h0 = n(b, H, P, N) * 0.1
    if broadcast:
        x = act(b, S, H * P + 2 * N).to(dtype)[..., :H * P].reshape(
            b, S, H, P)
        bc = act(b, S, 2 * N).to(dtype)
        Bm = bc[..., :N][:, :, None, :].expand(b, S, H, N)
        Cm = bc[..., N:][:, :, None, :].expand(b, S, H, N)
    else:
        x = act(b, S, H, P).to(dtype)
        Bm, Cm = (act(b, S, H, N).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm, D, h0


def normalised_err(a, b) -> float:
    return max_abs_err(a, b) / float(b.float().abs().max())


# K4 at the reference init's scale: the in-chunk prefix sums of dt*A reach
# ~1e4, where one fp32 ulp is ~1e-3, and every decay exp(cum_i - cum_j) of
# the chunked form inherits that round-off whatever order the sums are
# taken in (tests/test_torch_recurrences.py::
# test_ssd_chunked_at_the_reference_init_scale). There the kernel is held
# to 1e-3 of the largest magnitude of each output instead of the allclose.
INIT_SCALE_TOL = 1e-3


def check_ssd(name, b, S, H, P, N, chunk, dtype, broadcast, state=True,
              timed=False, init_scale=False, misaligned=False):
    """K4 against its plain version (the chunked form): y and the final
    state."""
    from repro_torch.kernels.ssd_chunk import ssd, ssd_plain

    x, dt, A, Bm, Cm, D, h0 = ssd_inputs(b, S, H, P, N, dtype, broadcast,
                                         SEED + 4, init_scale)
    if misaligned:
        x, Bm, Cm = (misalign(t) for t in (x, Bm, Cm))
    if not state:
        h0 = torch.zeros_like(h0)
    tol = RECURRENCE_TOL[dtype]
    got = ssd(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    want = ssd_plain(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    torch.cuda.synchronize()
    rec = {"case": name, "kernel": "ssd",
           "shape": {"b": b, "S": S, "H": H, "P": P, "N": N, "chunk": chunk},
           "dtype": str(dtype).replace("torch.", ""),
           "bc_head_stride": Bm.stride(2), "initial_state": state,
           "misaligned": misaligned,
           "max_abs_err": max_abs_err(got[0], want[0]),
           "state_max_abs_err": max_abs_err(got[1], want[1])}
    for t in got:
        require(bool(torch.isfinite(t).all()), f"{name}: not finite")
    if init_scale:
        rec.update(dt_mean=float(dt.mean()),
                   cum_min=float((dt * A).cumsum(1).min()),
                   y_abs_max=float(want[0].abs().max()),
                   normalised_err=max(normalised_err(a, c)
                                      for a, c in zip(got, want)),
                   tol=INIT_SCALE_TOL)
        require(rec["normalised_err"] <= INIT_SCALE_TOL,
                f"{name}: beyond {INIT_SCALE_TOL} of max|output|: {rec}")
    else:
        rec.update(allclose_excess=max(allclose_excess(a, c, tol)
                                       for a, c in zip(got, want)), tol=tol)
        require(rec["allclose_excess"] <= tol,
                f"{name}: outside allclose(atol=rtol={tol}): {rec}")
    if timed:
        item = x.element_size()
        n_chunks = S // chunk
        bc_bytes = 2 * b * S * N * item * (1 if broadcast else H)
        nbytes = (b * S * H * P * item + b * S * H * 4 + 2 * H * 4 + bc_bytes
                  + 2 * b * H * P * N * 4 + b * S * H * P * 4)
        pairs = chunk * (chunk + 1) // 2                # j <= i
        # C_i . B_j does not depend on the head when B and C are shared
        scores = 2 * N * pairs * (1 if broadcast else H)
        products = scores + H * (2 * P * pairs          # scores @ (x dt)
                                 + 4 * chunk * P * N)   # C h^T, carry
        flops = float(b * n_chunks * (products + H * (
            pairs                                       # the decays
            + 3 * chunk * P)))                          # x dt, D x

        def run_kernel():
            return ssd(x, dt, A, Bm, Cm, D, h0, chunk=chunk)

        def run_plain():
            return ssd_plain(x, dt, A, Bm, Cm, D, h0, chunk=chunk)

        rec.update(bound(nbytes, flops, PEAK_FLOPS[dtype]))
        rec.update(bound_3xtf32(nbytes, float(b * n_chunks * products)))
        rec.update(ms=device_ms(run_kernel), plain_ms=device_ms(run_plain,
                                                                reps=5),
                   eager_ms=time_ms(run_kernel),
                   eager_plain_ms=time_ms(run_plain, reps=5, warmup=1),
                   library_ms=None,
                   library_note="no PyTorch call computes the SSD scan")
        rec["ms_again"] = device_ms(run_kernel)
        rec["ms_third"] = device_ms(run_kernel)
    return rec


def check_recurrence_graph(name, kernel):
    """K3 or K4 at its main path's shape, called twice eagerly, then
    captured into one CUDA graph and replayed twice: the four (y, state)
    pairs must be bit-equal (no atomics, no data-dependent order)."""
    from repro_torch.kernels.rwkv6_chunk import wkv6
    from repro_torch.kernels.ssd_chunk import ssd

    if kernel == "wkv6":
        dtype = torch.bfloat16
        args = wkv6_inputs(1, 256, 64, 64, 64, dtype, SEED + 7)

        def call():
            return wkv6(*args, chunk=64)
    else:
        dtype = torch.float32
        args = ssd_inputs(1, 256, 80, 64, 64, dtype, True, SEED + 8)

        def call():
            return ssd(*args, chunk=64)

    outs = [tuple(t.clone() for t in call()) for _ in range(2)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(tuple(t.clone() for t in static))
    equal = [all(torch.equal(a, b) for a, b in zip(outs[0], o))
             for o in outs]
    rec = {"case": name, "kernel": kernel,
           "dtype": str(dtype).replace("torch.", ""),
           "eager_eager_graph_graph_bit_equal": equal}
    require(all(equal), f"{name}: outputs differ: {equal}")
    return rec


def time_designs(kernel, designs, turns=2):
    """The kernel's block shapes (``design``) at its main path's shape,
    timed in turns within this run (d0 d1 .. dn, then dn .. d0, ...): each
    design's device ms per turn, and its largest difference from design 0's
    output (a design changes the order of no sum, only who computes it)."""
    from repro_torch.kernels.rwkv6_chunk import wkv6
    from repro_torch.kernels.ssd_chunk import ssd

    if kernel == "wkv6":
        args = wkv6_inputs(1, 256, 64, 64, 64, torch.bfloat16, SEED + 3)

        def call(d):
            return wkv6(*args, chunk=64, design=d)
    else:
        x, dt, A, Bm, Cm, D, h0 = ssd_inputs(1, 256, 80, 64, 64,
                                             torch.float32, True, SEED + 4)

        def call(d):
            return ssd(x, dt, A, Bm, Cm, D, None, chunk=64, design=d)

    base = call(0)
    rec = {d: {"ms": [], "max_abs_diff_vs_design0": max(
        max_abs_err(a, b) for a, b in zip(call(d), base))} for d in designs}
    order = list(designs)
    for t in range(turns):
        for d in (order if t % 2 == 0 else order[::-1]):
            rec[d]["ms"].append(device_ms(lambda d=d: call(d)))
    return {"kernel": kernel, "designs": {str(d): v for d, v in rec.items()}}


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
                     timed=True, split=True,
                     plans=[(1, 1024), (8, 128), (16, 64)]),
        check_decode("decode/main/fp32", 8, 1024, 15, 5, 64, f32, ragged,
                     timed=True),
        check_decode("decode/scalar-len", 8, 1024, 15, 5, 64, bf16,
                     [333] * 8, scalar_len=333),
        check_decode("decode/len0-row", 4, 256, 15, 5, 64, f32,
                     [0, 1, 255, 256]),
        check_decode("decode/mha-d32", 2, 300, 4, 4, 32, f32, [300, 17]),
        check_decode("decode/g16-d128", 2, 512, 32, 2, 128, bf16, [512, 129]),
        check_decode("decode/mqa48-d128", 1, 640, 48, 1, 128, f32, [601]),
        # K1's split of the KV axis: a long single row (what it is for), a
        # ragged batch with rows that end before the first split boundary
        # (256) and a row of length 0, a batch large enough not to split,
        # and the counters' reset across eager calls and graph replays
        check_decode("decode/long-row/bf16", 1, 4096, 15, 5, 64, bf16,
                     [4000], timed=True, split=True,
                     plans=[(1, 4096), (32, 128), (8, 512)]),
        check_decode("decode/split-ragged/bf16", 4, 2048, 15, 5, 64, bf16,
                     [0, 100, 129, 2048], split=True),
        check_decode("decode/split-ragged/fp32", 4, 2048, 15, 5, 64, f32,
                     [0, 100, 129, 2048], split=True),
        check_decode("decode/no-split/bf16", 32, 256, 15, 5, 64, bf16,
                     [256, 0, 1, 255] * 8, split=False),
        check_decode_graph("decode/graph-replay/bf16", 8, 1024, 15, 5, 64,
                           bf16, ragged),
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
        # K2's tensor-core path at the edges the fp32 cases above cover
        check_flash("flash/ragged333/causal/bf16", 2, 333, 333, 15, 5, 64,
                    bf16, True),
        check_flash("flash/q_offset/bf16", 2, 100, 333, 15, 5, 64, bf16,
                    True, q_offset=233),
        check_flash("flash/q_offset-short/bf16", 1, 70, 200, 6, 2, 32, bf16,
                    True, q_offset=17),
        check_flash("flash/d32/bf16", 1, 256, 256, 6, 2, 32, bf16, True),
        check_flash("flash/sq1-skv77/bf16", 1, 1, 77, 15, 5, 64, bf16,
                    False),
        # K1 and K2 at zamba2-2.7b's shared attention: 32/32 heads, D=80;
        # K1 at the model phase's last decode step (256 cached positions)
        check_decode("decode/zamba2-d80/bf16", 1, 1024, 32, 32, 80, bf16,
                     [256], timed=True,
                     plans=[(1, 1024), (2, 512), (8, 128)]),
        check_decode("decode/zamba2-d80/fp32", 1, 1024, 32, 32, 80, f32,
                     [256]),
        check_decode("decode/d80-ragged", 3, 300, 32, 32, 80, bf16,
                     [1, 300, 77]),
        check_flash("flash/zamba2-d80/bf16", 1, 256, 256, 32, 32, 80, bf16,
                    True, timed=True),
        check_flash("flash/zamba2-d80/fp32", 1, 256, 256, 32, 32, 80, f32,
                    True),
        check_flash("flash/d80-ragged", 2, 133, 133, 8, 4, 80, bf16, False),
        # K1 and K2 at head_dim 128 on the MoE and vlm paths: arctic-480b's
        # 56/8 heads (a group of 7: one query head a block, so each block
        # reads its KV head's cache once per query head) and qwen2-vl-72b's
        # 64/8 (a group of 8, one block a KV head). K1 at arctic's batcher
        # step (8 slots, ragged) and at qwen2-vl's last decode step of the
        # model phase (256 cached positions), K2 at the 256-token prefill.
        # Beside arctic's K1, the same cache with a group of 8: what the
        # group of 7 costs
        check_decode("decode/arctic-g7-d128/bf16", 8, 1024, 56, 8, 128, bf16,
                     ragged, timed=True),
        check_decode("decode/arctic-g7-d128/fp32", 8, 1024, 56, 8, 128, f32,
                     ragged, timed=True),
        check_decode("decode/g8-d128-arctic-batch/bf16", 8, 1024, 64, 8, 128,
                     bf16, ragged, timed=True),
        check_decode("decode/qwen2vl-g8-d128/bf16", 1, 1024, 64, 8, 128, bf16,
                     [256], timed=True),
        check_decode("decode/qwen2vl-g8-d128/fp32", 1, 1024, 64, 8, 128, f32,
                     [256], timed=True),
        check_flash("flash/arctic-g7-d128/bf16", 1, 256, 256, 56, 8, 128,
                    bf16, True, timed=True),
        check_flash("flash/arctic-g7-d128/fp32", 1, 256, 256, 56, 8, 128, f32,
                    True, timed=True),
        check_flash("flash/qwen2vl-g8-d128/bf16", 1, 256, 256, 64, 8, 128,
                    bf16, True, timed=True),
        check_flash("flash/qwen2vl-g8-d128/fp32", 1, 256, 256, 64, 8, 128,
                    f32, True, timed=True),
        # K1 and K2 at whisper-small's shapes: 12/12 heads of 64 (a group of
        # 1). K2 non-causal over the 1500 encoder frames (1500 = 23 * 64 +
        # 28: a ragged last tile) and as cross attention (64 decoder
        # positions against the 1500 frames); K1 against the 1500-long
        # cross cache (every length 1500: the split plan's last chunk is
        # partial) and against a short self cache
        check_flash("flash/whisper-enc/bf16", 2, 1500, 1500, 12, 12, 64, bf16,
                    False, timed=True),
        check_flash("flash/whisper-enc/fp32", 2, 1500, 1500, 12, 12, 64, f32,
                    False),
        check_flash("flash/whisper-cross/bf16", 2, 64, 1500, 12, 12, 64, bf16,
                    False, timed=True),
        check_flash("flash/whisper-cross/fp32", 2, 64, 1500, 12, 12, 64, f32,
                    False),
        check_flash("flash/whisper-dec-causal/bf16", 2, 36, 36, 12, 12, 64,
                    bf16, True),
        check_decode("decode/whisper-cross/bf16", 2, 1500, 12, 12, 64, bf16,
                     [1500, 1500], timed=True, split=True),
        check_decode("decode/whisper-cross/fp32", 2, 1500, 12, 12, 64, f32,
                     [1500, 1500], split=True),
        check_decode("decode/whisper-self/bf16", 2, 36, 12, 12, 64, bf16,
                     [17, 17]),
        # K3 at rwkv6-7b's forward (64 heads of 64, chunk 64, the 256-token
        # prompt of the model phase, zero initial state) and at the edges
        check_wkv6("wkv6/main/bf16", 1, 256, 64, 64, 64, 64, bf16,
                   state=False, timed=True),
        check_wkv6("wkv6/main/fp32", 1, 256, 64, 64, 64, 64, f32,
                   state=False, timed=True),
        check_wkv6("wkv6/S512/bf16", 1, 512, 64, 64, 64, 64, bf16,
                   state=False, timed=True),
        check_wkv6("wkv6/one-chunk", 1, 64, 64, 64, 64, 64, bf16),
        check_wkv6("wkv6/state-B2/fp32", 2, 128, 8, 64, 64, 32, f32),
        check_wkv6("wkv6/dk16-dv24/fp32", 2, 128, 3, 16, 24, 32, f32),
        check_wkv6("wkv6/dk16-dv24/bf16", 2, 128, 3, 16, 24, 16, bf16),
        # K3 on the tensor cores (3xTF32): every log w at the clamp, where
        # the factors reach e^32 and the split's error is largest; the main
        # shape at chunk 32; eager against CUDA-graph replay
        check_wkv6("wkv6/strong-decay/fp32", 1, 256, 64, 64, 64, 64, f32,
                   strong_decay=True),
        check_wkv6("wkv6/main/fp32/chunk32", 1, 256, 64, 64, 64, 32, f32,
                   state=False),
        check_recurrence_graph("wkv6/graph-replay/bf16", "wkv6"),
        check_wkv6("wkv6/misaligned/bf16", 2, 128, 8, 64, 64, 32, bf16,
                   misaligned=True),
        # K4 at zamba2-2.7b's forward (80 heads, P = N = 64, chunk 64, fp32
        # as the model passes them, B/C broadcast over heads) and the edges
        check_ssd("ssd/main/fp32", 1, 256, 80, 64, 64, 64, f32, True,
                  state=False, timed=True),
        check_ssd("ssd/S512/fp32", 1, 512, 80, 64, 64, 64, f32, True,
                  state=False, timed=True),
        check_ssd("ssd/init-scale/fp32", 1, 256, 80, 64, 64, 64, f32, True,
                  state=False, init_scale=True),
        check_ssd("ssd/contiguous-bc/fp32", 1, 256, 80, 64, 64, 64, f32,
                  False),
        check_ssd("ssd/one-chunk/bf16", 1, 64, 80, 64, 64, 64, bf16, True),
        check_ssd("ssd/state-B2/fp32", 2, 128, 6, 64, 64, 32, f32, True),
        check_ssd("ssd/state-B2/bf16", 2, 128, 6, 32, 16, 16, bf16, False),
        # K4 on the tensor cores (3xTF32) at full width: chunks of 32 and 16
        # (the mma tiles' edges), bf16 inputs, eager against graph replay
        check_ssd("ssd/main/fp32/chunk32", 1, 256, 80, 64, 64, 32, f32, True,
                  state=False),
        check_ssd("ssd/main/fp32/chunk16", 1, 256, 80, 64, 64, 16, f32, True,
                  state=False),
        check_ssd("ssd/main/bf16", 1, 256, 80, 64, 64, 64, bf16, True,
                  state=False),
        check_recurrence_graph("ssd/graph-replay/fp32", "ssd"),
        check_ssd("ssd/misaligned/fp32", 2, 128, 6, 64, 64, 32, f32, False,
                  misaligned=True),
    ]
    emit("kernels", cases=cases)
    emit("designs", steps=[time_designs("ssd", SSD_DESIGNS),
                           time_designs("wkv6", WKV6_DESIGNS)])
    by_case = {c["case"]: c for c in cases}
    return {"decode_attention": by_case["decode/main/bf16"],
            "flash_attention": by_case["flash/main/bf16"],
            "wkv6": by_case["wkv6/main/bf16"],
            "ssd": by_case["ssd/main/fp32"]}


# -- phase: model ---------------------------------------------------------------

def prefill_vs_decode(cfg, run_kernel, run_plain, prompt_len, tol, label,
                      init_kw, full_depth):
    """forward (on the kernels: flash attention, WKV6 or SSD) vs the same
    prompt fed token by token through decode_step (flash-decode where the
    model attends) vs the same weights on the plain versions; last-position
    logits. The plain twin is built on 'meta' and takes the kernel model's
    tensors themselves (``assign=True``): at arctic-480b's width two copies
    would not fit in the card's memory."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import build_model

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, run_kernel, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                      **init_kw)
    plain = build_model(cfg, run_plain, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    require(plain.embed.data_ptr() == model.embed.data_ptr(),
            f"{label}: the plain twin does not share the weights")
    g = torch.Generator().manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (1, prompt_len), generator=g,
                         dtype=torch.int32).cuda()
    with torch.inference_mode():
        t0 = time.perf_counter()
        fwd = model.forward({"tokens": toks})[:, -1].float()
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        # again, once the first call's library set-up (cuBLAS heuristics
        # for each new product shape) is paid
        t0 = time.perf_counter()
        model.forward({"tokens": toks})
        torch.cuda.synchronize()
        fwd_again_s = time.perf_counter() - t0
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
        "leg": label, "n_layers": cfg.n_layers, "full_depth": full_depth,
        "dtype": cfg.dtype, "prompt_len": prompt_len, "tol": tol,
        "logit_std": float(fwd_plain.std()),
        "forward_kernel_vs_decode_kernel": max_abs_err(fwd, dec),
        "forward_kernel_vs_forward_plain": max_abs_err(fwd, fwd_plain),
        "decode_kernel_vs_decode_plain": max_abs_err(dec, dec_plain),
        "forward_plain_vs_decode_plain": max_abs_err(fwd_plain, dec_plain),
        "argmax_agree": bool(fwd.argmax(-1).equal(dec.argmax(-1))
                             and fwd.argmax(-1).equal(fwd_plain.argmax(-1))),
        "forward_seconds": round(fwd_s, 4),
        "forward_seconds_again": round(fwd_again_s, 4),
        "decode_ms_per_step": round(dec_s / prompt_len * 1e3, 4),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("model-leg", config=cfg.name, init=init_kw, **rec)
    for t in (fwd, dec, fwd_plain, dec_plain):
        require(t.shape == (1, cfg.vocab), f"{label}: logits shape {t.shape}")
        require(bool(torch.isfinite(t).all()), f"{label}: logits not finite")
    for key in ("forward_kernel_vs_decode_kernel",
                "forward_kernel_vs_forward_plain",
                "decode_kernel_vs_decode_plain"):
        require(rec[key] <= tol, f"{label}: {key} = {rec[key]} > {tol}")
    del model, plain, cache, cache_p
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# Model-level tolerances, on last-position logits of standard deviation ~1
# (printed as logit_std beside them), for every comparison of a leg:
#  * fp32 at cut depth: 2e-3. The seed's weight scales (``dense_init``
#    handed the stacked shape, so fan_in is L) make softmax rows sharply
#    peaked and recurrent activations large, which amplifies 1e-6 round-off
#    per layer.
#  * bf16 at full depth: 0.5. Every op rounds to 8 bits of mantissa and the
#    two paths round at different places.
# zamba2-2.7b's legs draw their weights with ``layer_fan_in`` (a deviation
# from the reference's init): under the reference's, dt ~ 17 puts the
# chunked SSD's prefix sums where fp32 loses ~1e-3 and the residual stream
# near 1e7, so the forward cannot meet decode at these limits whatever
# computes it and the shared attention's round-off is invisible
# (tests/test_torch_zamba2.py::test_chunked_ssd_conditioning_at_init_scale,
# test_layer_fan_in_init_is_well_conditioned). K4 at the reference's scale
# is held in the kernels phase (ssd/init-scale).
FP32_TOL, BF16_TOL = 2e-3, 0.5


def phase_model(cfg, fp32_depth, bf16_depth=None, init_kw=None,
                **run_kw) -> None:
    """The ``model`` legs of one configuration, both at full width: fp32 at
    ``fp32_depth`` layers, bf16 at ``bf16_depth`` (full depth when None).
    ``run_kw`` goes into both RunConfigs (the recurrences' ``seq_chunk``),
    ``init_kw`` into ``init_params``."""
    from dataclasses import replace

    from repro_torch.models.api import RunConfig

    init_kw = init_kw or {}
    run_kernel = RunConfig(attn_impl="kernel", **run_kw)
    run_plain = RunConfig(attn_impl="plain", **run_kw)
    bf16_depth = bf16_depth or cfg.n_layers
    legs = [prefill_vs_decode(
        replace(cfg, n_layers=fp32_depth, dtype="float32"), run_kernel,
        run_plain, prompt_len=256, tol=FP32_TOL,
        label=f"fp32-depth{fp32_depth}", init_kw=init_kw,
        full_depth=cfg.n_layers)]
    legs.append(prefill_vs_decode(
        replace(cfg, n_layers=bf16_depth), run_kernel, run_plain,
        prompt_len=256, tol=BF16_TOL,
        label="bf16-full" if bf16_depth == cfg.n_layers
        else f"bf16-depth{bf16_depth}",
        init_kw=init_kw, full_depth=cfg.n_layers))
    emit("model", config=cfg.name, run=run_kw, init=init_kw, legs=legs)


# -- phase: serve ---------------------------------------------------------------

def host_syncs(fn) -> Optional[int]:
    """Times ``fn`` makes the host wait for the device, as CUDA's sync debug
    mode reports them (one warning each); None when it reported none (then
    not measured: a decode step waits at least once, for its argmax)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum(1 for w in caught if "synchroniz" in str(w.message).lower())
    return n or None


def kernel_rows(prof) -> list:
    """(name, device microseconds, launches) of each kernel a
    ``torch.profiler`` run saw, most time first. Kernel rows only: an
    operator's row repeats its kernels' device time."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_decode_steps(cfg, cache, prompts, n_steps: int = 8) -> dict:
    """Steady state of one replica with every slot busy: wall time per
    lockstep decode step, the host's waits for the device per step, and
    from ``torch.profiler`` the share of that wall time during which the
    device ran a kernel, with the kernels that took most of it. Device
    numbers are None when the profiler saw no device activity (they are
    then not measured, not zero)."""
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
    syncs = host_syncs(lambda: [cb.step() for _ in range(2)])
    rows = kernel_rows(prof)
    busy_us = sum(r[1] for r in rows)
    out = {"slots_busy": MAX_SLOTS, "steps": n_steps,
           "ms_per_step": step_ms, "ms_per_step_traced": traced_ms,
           "tokens_per_s": MAX_SLOTS / step_ms * 1e3,
           "host_syncs_per_step": None if syncs is None else syncs / 2,
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


def serve_prompts(cfg):
    """The serve traffic: N_REQUESTS prompts of 16-64 tokens."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist()
            for _ in range(N_REQUESTS)]


def start_cluster(cfg, lb, **scaling):
    """A 4-worker cluster with the live backend and one function "llm"
    whose sandboxes take MAX_SLOTS requests at a time."""
    from repro_torch.core import Cluster, Function, ScalingConfig
    from repro_torch.simcore import Environment

    env = Environment(seed=7)
    cluster = Cluster(env, n_workers=4, runtime="firecracker",
                      live_backend=lb, sandbox_concurrency=MAX_SLOTS)
    cluster.start()
    cluster.register_sync(Function(
        name="llm", image_url=f"registry://{cfg.name}", port=9000,
        scaling=ScalingConfig(target_concurrency=MAX_SLOTS, **scaling)))
    return env, cluster


def invoke_all(env, cluster, prompts, horizon=120.0):
    """Send one request per prompt and run the simulation until all are
    done or failed (or ``horizon`` simulated seconds pass)."""
    from repro_torch.core.request import LiveRequest

    invs = [cluster.invoke("llm", exec_time=0.05, request=LiveRequest(
        prompt=p, max_new_tokens=MAX_NEW)) for p in prompts]
    end = env.now + horizon
    while env.now < end and not all(i.t_done > 0 or i.failed for i in invs):
        env.run(until=env.now + 0.5)
    return invs


def check_served(cfg, invs, lb) -> None:
    served = [i for i in invs if i.t_done > 0 and not i.failed]
    require(len(served) == len(invs),
            f"served {len(served)}/{len(invs)}: "
            f"{[i.failure_reason for i in invs if i.failed]}; failed "
            f"creations: {lb.create_errors}")
    for i in invs:
        toks = i.request.tokens
        require(toks is not None and len(toks) == MAX_NEW,
                f"request {i.inv_id}: tokens {toks}")
        require(all(0 <= t < cfg.vocab for t in toks), "token id out of range")


def wall_percentiles(invs) -> dict:
    walls = sorted(i.request.wall_s for i in invs)
    return {"invoke_wall_p50_s": walls[len(walls) // 2],
            "invoke_wall_p99_s": walls[min(len(walls) - 1,
                                           math.ceil(0.99 * len(walls)) - 1)]}


def recording_backend():
    """A LiveBackend class that remembers which sandbox took which request
    and why a creation failed (the simulation does not report it)."""
    from repro_torch.live import LiveBackend

    class RecordingBackend(LiveBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sandbox_of = {}
            self.create_errors = []

        def create_hook(self, sandbox):
            try:
                super().create_hook(sandbox)
            except Exception as e:
                self.create_errors.append(repr(e))
                raise

        def admit(self, sandbox_id, req):
            ticket = super().admit(sandbox_id, req)
            self.sandbox_of[id(req)] = sandbox_id
            return ticket

    return RecordingBackend


def phase_serve(cfg, reused_probe: bool = False, max_scale=None,
                full_depth=None) -> dict:
    """16 requests through the orchestrator into live replicas. The probe
    (a request whose batched tokens must equal a solo replica's on its
    sandbox's weights) is the first request, or with ``reused_probe`` one
    more request sent after the 16 are done, which the batcher admits into
    a slot that has served or idled through earlier steps: a recurrent
    model that leaked a slot's state into its next request fails it.
    ``max_scale`` caps the function's sandboxes (one replica at a time
    when a replica needs most of the card). Returns the line it prints."""
    from repro_torch.kernels import ops
    from repro_torch.live import LiveFunctionSpec
    from repro_torch.serving.engine import Replica
    from repro_torch.serving.exec_cache import ExecutableCache

    class CountingBackend(recording_backend()):
        """Also remembers which slot took which request and how many decode
        steps every sandbox's batcher took, teardowns included."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.admitted = {}
            self.slots_used = set()
            self.retired_steps = 0

        def admit(self, sandbox_id, req):
            rt = self.sandboxes.get(sandbox_id)
            steps = None if rt is None else rt.batcher.steps
            ticket = super().admit(sandbox_id, req)
            slot = next(i for i, sl in enumerate(rt.batcher.slots)
                        if sl.active and sl.request_id == ticket.rid)
            self.admitted[id(req)] = {
                "sandbox": sandbox_id, "slot": slot, "steps_before": steps,
                "slot_served_before": (sandbox_id, slot) in self.slots_used}
            self.slots_used.add((sandbox_id, slot))
            return ticket

        def teardown_hook(self, sandbox_id, drain=True):
            rt = self.sandboxes.get(sandbox_id)
            super().teardown_hook(sandbox_id, drain)
            if rt is not None:
                self.retired_steps += rt.batcher.steps

        def decode_steps(self):
            return self.retired_steps + sum(
                rt.batcher.steps for rt in self.sandboxes.values())

    torch.cuda.reset_peak_memory_stats()
    cache = ExecutableCache()
    spec = LiveFunctionSpec(cfg=cfg, max_seq=MAX_SEQ, max_slots=MAX_SLOTS)
    lb = CountingBackend(default_spec=spec, exec_cache=cache)
    scaling = {} if max_scale is None else {"max_scale": max_scale}
    env, cluster = start_cluster(cfg, lb, **scaling)
    prompts = serve_prompts(cfg)
    before = ops.launch_counts()
    warmed_before = cache.compiled_executables()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    invs = invoke_all(env, cluster, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    check_served(cfg, invs, lb)
    require(lb.batched_invokes > 0, "no invocation shared a decode step")
    steps = lb.decode_steps()
    warmed = cache.compiled_executables() - warmed_before
    moved = {k: v - before[k] for k, v in ops.launch_counts().items()}
    if cfg.family == "ssm":
        # the recurrent decode step is plain arithmetic: no kernel
        require(not any(moved.values()),
                f"kernel launches on the recurrent decode path: {moved}")
    else:
        require(moved["decode_attention"] == (steps + warmed) * cfg.n_layers,
                f"decode kernel launches {moved['decode_attention']} != "
                f"(steps {steps} + warm-up steps {warmed}) x layers "
                f"{cfg.n_layers}")
    reuse_count = sum(1 for i in invs
                      if lb.admitted[id(i.request)]["steps_before"] > 0)
    invoke_s, tokens_total = lb.invoke_seconds_total, lb.tokens_total

    probe, probe_prompt = invs[0], prompts[0]
    if reused_probe:
        probe_prompt = prompts[N_REQUESTS // 2]
        probe = invoke_all(env, cluster, [probe_prompt])[0]
        require(probe.t_done > 0 and not probe.failed,
                f"probe request failed: {probe.failure_reason}")
        where = lb.admitted[id(probe.request)]
        require(where["steps_before"] > 0,
                f"the probe's slot had run no decode step before: {where}")
    where = lb.admitted[id(probe.request)]
    colds = [r["wall_s"] for r in lb.start_log if r["cold"]]
    warms = [r["wall_s"] for r in lb.start_log if not r["cold"]]
    stats = lb.cache_stats()
    replicas_created = len(lb.start_log)
    peak = torch.cuda.max_memory_allocated()
    lb.close()
    require(lb.replicas_live == 0, "replicas left after close()")
    gc.collect()
    torch.cuda.empty_cache()

    # the probe against a fresh replica with its sandbox's seed: the same
    # weights, alone in a batch of one, must give the same greedy tokens
    solo = Replica(cfg, rng_seed=where["sandbox"], max_seq=MAX_SEQ,
                   run_cfg=spec.run_cfg, exec_cache=cache).generate(
        probe_prompt, max_new_tokens=MAX_NEW)
    got = probe.request.tokens
    same = sum(int(a == b) for a, b in zip(solo, got))
    require(solo == got,
            f"batched tokens differ from a solo replica's ({same}/{MAX_NEW} "
            f"equal): {got} vs {solo}")
    torch.cuda.empty_cache()

    profile = profile_decode_steps(cfg, cache, prompts)
    rec = dict(
        config=cfg.name, n_layers=cfg.n_layers,
        full_depth=full_depth or cfg.n_layers, max_scale=max_scale,
        requests=N_REQUESTS, served=len(invs), max_new_tokens=MAX_NEW,
        prompt_lens=[len(p) for p in prompts],
        replicas_created=replicas_created,
        create_cold_s=colds, create_warm_s=warms, **wall_percentiles(invs),
        invoke_seconds_total=invoke_s, tokens_total=tokens_total,
        tokens_per_s=tokens_total / wall, wall_s=wall, decode_steps=steps,
        warm_steps=warmed, ms_per_decode_step=invoke_s / max(steps, 1) * 1e3,
        batched_invokes=lb.batched_invokes, kernel_launches=moved,
        teardowns=lb.teardowns, exec_cache=stats,
        admitted_after_steps=reuse_count,
        probe={"reused": reused_probe, **where, "tokens_equal_solo": True},
        steady_state=profile, peak_memory_bytes=peak)
    emit("serve", **rec)
    return rec


def phase_container(cfg, process_serve: dict) -> None:
    """The serve traffic with one worker process per sandbox
    (``LiveFunctionSpec(mode="container")``), the kernel library built by
    the first creation into a fresh build directory inside the checkout
    and loaded by the later ones. The parent cannot read the children's
    launch counters (the protocol carries tokens only), so each request's
    tokens are held against an in-process replica with its sandbox's seed,
    batched likewise, whose flash-decode launches are counted here."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.live import LiveFunctionSpec
    from repro_torch.serving.engine import ContinuousBatcher, Replica
    from repro_torch.serving.exec_cache import ExecutableCache

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    build_dir = tempfile.mkdtemp(prefix="container-",
                                 dir=os.path.join(ROOT, "build"))
    spec = LiveFunctionSpec(cfg=cfg, mode="container", max_seq=MAX_SEQ,
                            max_slots=MAX_SLOTS)
    lb = recording_backend()(default_spec=spec, exec_cache=ExecutableCache(),
                             compile_cache_dir=build_dir)
    try:
        env, cluster = start_cluster(cfg, lb)
        prompts = serve_prompts(cfg)
        t0 = time.perf_counter()
        invs = invoke_all(env, cluster, prompts)
        wall = time.perf_counter() - t0
        check_served(cfg, invs, lb)
    finally:
        lb.close()
        shutil.rmtree(build_dir, ignore_errors=True)
    require(lb.replicas_live == 0, "container workers left after close()")
    colds = [r["wall_s"] for r in lb.start_log if r["cold"]]
    warms = [r["wall_s"] for r in lb.start_log if not r["cold"]]
    require(all(r["mode"] == "container" for r in lb.start_log),
            f"not container creations: {lb.start_log}")
    require(colds and warms, f"needs a cold and a warm creation: "
            f"{lb.start_log}")

    # every request's tokens against an in-process replica with its
    # sandbox's seed, its requests batched in waves of MAX_SLOTS
    by_sandbox = {}
    for inv, prompt in zip(invs, prompts):
        by_sandbox.setdefault(lb.sandbox_of[id(inv.request)], []).append(
            (prompt, inv.request.tokens))
    before = ops.launch_counts()
    steps = 0
    for sid, reqs in sorted(by_sandbox.items()):
        rep = Replica(cfg, rng_seed=sid, max_seq=MAX_SEQ,
                      exec_cache=ExecutableCache())
        cb = ContinuousBatcher(rep, max_slots=MAX_SLOTS)
        for w in range(0, len(reqs), MAX_SLOTS):
            wave = reqs[w:w + MAX_SLOTS]
            rids = [cb.add_request(p, max_new=MAX_NEW) for p, _ in wave]
            cb.run_until_done()
            for rid, (_, toks) in zip(rids, wave):
                require(cb.finished[rid] == toks,
                        f"sandbox {sid}: container tokens {toks} != "
                        f"in-process {cb.finished[rid]}")
        steps += cb.steps
        del rep, cb
    moved = {k: v - before[k] for k, v in ops.launch_counts().items()}
    require(moved["decode_attention"] == steps * cfg.n_layers,
            f"in-process decode kernel launches {moved['decode_attention']} "
            f"!= steps {steps} x layers {cfg.n_layers}")
    emit("container", config=cfg.name, requests=N_REQUESTS,
         served=len(invs), replicas_created=len(lb.start_log),
         create_cold_s=colds, create_warm_s=warms,
         process_mode_create_cold_s=process_serve["create_cold_s"],
         process_mode_create_warm_s=process_serve["create_warm_s"],
         **wall_percentiles(invs), invoke_seconds_total=lb.invoke_seconds_total,
         tokens_total=lb.tokens_total, wall_s=wall,
         tokens_per_s=lb.tokens_total / wall,
         batched_invokes=lb.batched_invokes, teardowns=lb.teardowns,
         sandboxes={str(k): len(v) for k, v in sorted(by_sandbox.items())},
         tokens_equal_in_process=True, in_process_decode_steps=steps,
         in_process_kernel_launches=moved,
         child_kernel_launches="not visible to the parent: the protocol "
                               "carries tokens only")


def phase_generate(cfg) -> None:
    """Replica.generate (batch 1, the prompt fed through decode_step) twice
    on the same weights: the greedy tokens must be equal and in range."""
    import numpy as np

    from repro_torch.serving.engine import Replica
    from repro_torch.serving.exec_cache import ExecutableCache

    prompt = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab, 48).tolist()
    runs = []
    for _ in range(2):
        rep = Replica(cfg, rng_seed=SEED, max_seq=MAX_SEQ,
                      exec_cache=ExecutableCache())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = rep.generate(prompt, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0))
        del rep
        torch.cuda.empty_cache()
    (a, sa), (b, sb) = runs
    require(len(a) == MAX_NEW and all(0 <= t < cfg.vocab for t in a),
            f"generate: tokens {a}")
    require(a == b, f"generate differs between two runs on the same "
            f"weights: {a} vs {b}")
    steps = len(prompt) + MAX_NEW
    emit("generate", config=cfg.name, prompt_len=len(prompt),
         max_new_tokens=MAX_NEW, tokens=a, seconds=[sa, sb],
         ms_per_step=[sa / steps * 1e3, sb / steps * 1e3])


# -- phase: whisper -------------------------------------------------------------

WHISPER_BATCH = 2
WHISPER_PROMPT = 4    # tokens fed through decode_step before the greedy ones


def whisper_leg(cfg, tol, label, init_kw) -> dict:
    """whisper-small at full width in one dtype: ``encode`` and ``forward``
    on the kernels (K2: non-causal over the frames, causal over the
    tokens, cross attention) against the same weights on the plain forms;
    ``prefill_cross``, then WHISPER_PROMPT prompt tokens and MAX_NEW greedy
    tokens through ``decode_step`` (K1 against the self cache and the
    1500-long cross cache); the decode logits against ``forward``'s at
    every position. Frames are drawn on the card."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import RunConfig, build_model

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, RunConfig(attn_impl="kernel"), device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                      **init_kw)
    plain = build_model(cfg, RunConfig(attn_impl="plain"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, steps = WHISPER_BATCH, WHISPER_PROMPT + MAX_NEW
    frames = torch.randn((b, model.enc_seq, cfg.d_model), generator=g,
                         device="cuda").to(model.embed.dtype)
    prompt = torch.randint(0, cfg.vocab, (b, WHISPER_PROMPT), generator=g,
                           device="cuda", dtype=torch.int32)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        enc, enc_s = timed(lambda: model.encode(frames))
        _, enc_again_s = timed(lambda: model.encode(frames))
        enc_plain = plain.encode(frames)
        cache = model.init_cache(ShapeSpec("w", steps, b, "decode"))
        _, prefill_s = timed(lambda: model.prefill_cross(frames, cache))
        fed, logits = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            tok = prompt[:, t:t + 1] if t < WHISPER_PROMPT else nxt
            lg, cache = model.decode_step(cache, {"tokens": tok,
                                                  "cache_len": t})
            fed.append(tok)
            logits.append(lg.float())
            nxt = torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec = torch.stack(logits, dim=1)
        batch = {"frames": frames, "tokens": torch.cat(fed, dim=1)}
        fwd, fwd_s = timed(lambda: model.forward(batch).float())
        _, fwd_again_s = timed(lambda: model.forward(batch))
        fwd_plain = plain.forward(batch).float()
    rec = {
        "leg": label, "dtype": cfg.dtype, "batch": b,
        "encoder_seq": model.enc_seq, "n_layers": cfg.n_layers,
        "n_encoder_layers": model.enc_layers, "decode_steps": steps,
        "tol": tol, "logit_std": float(fwd_plain.std()),
        "encode_kernel_vs_encode_plain": max_abs_err(enc, enc_plain),
        "forward_kernel_vs_forward_plain": max_abs_err(fwd, fwd_plain),
        "decode_kernel_vs_forward_kernel": max_abs_err(dec, fwd),
        "argmax_agree": bool(dec.argmax(-1).equal(fwd.argmax(-1))),
        "encode_seconds": [enc_s, enc_again_s], "prefill_cross_s": prefill_s,
        "forward_seconds": [fwd_s, fwd_again_s],
        "decode_ms_per_step": dec_s / steps * 1e3,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("whisper-leg", config=cfg.name, init=init_kw, **rec)
    require(fwd.shape == (b, steps, cfg.vocab), f"{label}: {fwd.shape}")
    for name, t in (("encode", enc), ("forward", fwd), ("decode", dec),
                    ("forward plain", fwd_plain)):
        require(bool(torch.isfinite(t.float()).all()),
                f"{label}: {name} not finite")
    for key in ("encode_kernel_vs_encode_plain",
                "forward_kernel_vs_forward_plain",
                "decode_kernel_vs_forward_kernel"):
        require(rec[key] <= tol, f"{label}: {key} = {rec[key]} > {tol}")
    del model, plain, cache, enc, enc_plain
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def whisper_init_scale(cfg) -> dict:
    """Recorded, not gated: the encoder at the reference's init (fp32),
    kernel against plain and plain against the O(S^2) oracle. Its matrices
    are drawn at the stacked fan-in (12 for a 768-wide input), scores have
    a std of ~64 and rows are one-hot, so near-ties that two orderings of
    the same fp32 arithmetic break differently move whole rows (ROADMAP
    §C9); the legs above run on ``layer_fan_in`` weights."""
    from repro_torch.models.api import RunConfig, build_model

    model = build_model(cfg, RunConfig(attn_impl="kernel"), device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    frames = torch.randn((WHISPER_BATCH, model.enc_seq, cfg.d_model),
                         generator=torch.Generator(device="cuda").manual_seed(
                             SEED + 3), device="cuda")
    outs = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain", "reference"):
            model.run = RunConfig(attn_impl=impl)
            outs[impl] = model.encode(frames)
    rec = {"dtype": cfg.dtype, "init": "reference",
           "encode_kernel_vs_plain": max_abs_err(outs["kernel"],
                                                 outs["plain"]),
           "encode_plain_vs_reference": max_abs_err(outs["plain"],
                                                    outs["reference"])}
    del model, outs
    torch.cuda.empty_cache()
    return rec


def phase_whisper(cfg) -> None:
    """Full depth (12 + 12 layers) in fp32 and in bf16, on weights drawn at
    the per-layer fan-in (``layer_fan_in``); the reference's init recorded
    beside them."""
    from dataclasses import replace

    fan = {"layer_fan_in": True}
    f32 = replace(cfg, dtype="float32")
    legs = [whisper_leg(f32, FP32_TOL, "fp32-full", fan),
            whisper_leg(cfg, BF16_TOL, "bf16-full", fan)]
    emit("whisper", config=cfg.name, legs=legs,
         reference_init=whisper_init_scale(f32))


# -- phase: train ---------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 256, 3e-3


def probe_grad_refusal() -> list:
    """Each kernel's wrapper, handed a CUDA input that requires grad, must
    raise before it launches (ROADMAP §C6)."""
    from repro_torch.kernels import ops

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, device="cuda", dtype=dtype)

    cases = {
        "flash_attention": lambda q: ops.flash_attention(
            q, t(1, 64, 2, 64), t(1, 64, 2, 64)),
        "decode_attention": lambda q: ops.decode_attention(
            q[:, :1].contiguous(), t(1, 64, 2, 64), t(1, 64, 2, 64), 64),
        "wkv6": lambda q: ops.wkv6(q, t(1, 64, 2, 64), t(1, 64, 2, 64),
                                   torch.rand((1, 64, 2, 64), device="cuda"),
                                   t(2, 64)),
        "ssd": lambda q: ops.ssd(q, torch.rand((1, 64, 2), device="cuda"),
                                 -torch.ones(2, device="cuda"),
                                 t(1, 64, 2, 16), t(1, 64, 2, 16),
                                 t(2)),
    }
    refused = []
    for name, call in cases.items():
        before = ops.launch_counts()[name]
        q = t(1, 64, 2, 64).requires_grad_(True)
        try:
            call(q)
        except RuntimeError as e:
            require('attn_impl="plain"' in str(e), f"{name}: {e}")
            refused.append(name)
        require(ops.launch_counts()[name] == before,
                f"{name}: launched with a grad-requiring input")
    require(len(refused) == len(cases),
            f"kernels that took a grad-requiring input: "
            f"{sorted(set(cases) - set(refused))}")
    return refused


ADAMW_EPS = 1e-8


def accum_pair(cfg, layer_fan_in: bool) -> dict:
    """One AdamW step from the gradients of the whole batch against one from
    grad_accum 2 over the same batch (``loss_and_grads``, the train step's
    own), the same weights (the Trainer's, drawn again at the per-layer
    fan-in when asked). Compared: the loss, the gradients, and the
    parameters after the step, the latter split by the gradient's size:
    where either run's gradient is below 100 * AdamW's eps the first step's
    update g / (|g| + eps) is not yet sign(g) and a 1e-9 change of g moves
    it by a fraction of lr, so those elements are counted and bounded by
    what one step can move (2 * lr), the others held to atol 1e-4, rtol
    1e-3."""
    from repro_torch.launch.train import Trainer, run_config
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import loss_and_grads

    runs = []
    for accum in (1, 2):
        tr = Trainer(cfg, run_config(grad_accum=accum), seq=TRAIN_SEQ,
                     batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                     device="cuda")
        if layer_fan_in:
            tr.model.init_params(
                torch.Generator(device="cuda").manual_seed(SEED),
                layer_fan_in=True)
        loss, grads = loss_and_grads(tr.model, tr.stream.batch_at(0), accum)
        grads = {k: g.float() for k, g in grads.items()}
        adamw_update(grads, tr.opt, tr.params, lr=TRAIN_LR)
        runs.append((float(loss), grads,
                     {k: p.detach() for k, p in tr.params.items()}))
        del tr
    (l1, g1, p1), (l2, g2, p2) = runs
    grad_excess, outside, small, small_max_dp, excess = 0.0, 0, 0, 0.0, 0.0
    for k in p1:
        scale = max(1.0, float(g1[k].abs().max()))
        grad_excess = max(grad_excess, float(
            ((g1[k] - g2[k]).abs() - 1e-3 * g1[k].abs()).max()) / scale)
        dp = (p1[k] - p2[k]).abs()
        tight = torch.minimum(g1[k].abs(), g2[k].abs()) >= 100 * ADAMW_EPS
        over = dp - 1e-3 * p2[k].abs()
        excess = max(excess, float(torch.where(tight, over, 0.0).max()))
        outside += int(((over > 1e-4) & tight).sum())
        small += int((~tight).sum())
        small_max_dp = max(small_max_dp, float(torch.where(
            tight, 0.0, dp).max()))
    del runs, g1, g2, p1, p2
    torch.cuda.empty_cache()
    return {"layer_fan_in": layer_fan_in, "loss": [l1, l2],
            "loss_rel_diff": abs(l1 - l2) / abs(l1),
            "grad_max_excess_over_rtol_per_scale": grad_excess,
            "param_max_excess_over_rtol": excess,
            "params_outside_tol": outside,
            "params_with_grad_below_100_eps": small,
            "their_max_param_diff": small_max_dp}


def accum_equivalence(cfg) -> dict:
    """tests/test_train.py::test_grad_accum_equivalence on the card, gated
    on weights drawn at the per-layer fan-in: loss rtol 1e-5, gradients
    atol 1e-4 (in units of a leaf's largest where that exceeds 1) and rtol
    1e-3, parameters atol 1e-4, rtol 1e-3 where the gradient is above
    100 * eps and within 2 * lr where it is not (``accum_pair``). The
    reference's init is recorded beside it, not gated: its one-hot
    attention rows break near-ties differently in a batch of 8 and two of
    4 (other GEMM shapes, other rounding), which moves whole rows'
    gradients (ROADMAP §C4)."""
    rec = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "gated": accum_pair(cfg, layer_fan_in=True),
           "reference_init": accum_pair(cfg, layer_fan_in=False)}
    gated = rec["gated"]
    require(gated["loss_rel_diff"] <= 1e-5, f"accum: loss {gated['loss']}")
    require(gated["grad_max_excess_over_rtol_per_scale"] <= 1e-4,
            f"accum: gradients differ: {gated}")
    require(gated["params_outside_tol"] == 0
            and gated["their_max_param_diff"] <= 2 * TRAIN_LR + 1e-4,
            f"accum: parameters differ: {gated}")
    return rec


def profile_train_step(tr, step: int) -> dict:
    """One more train step under ``torch.profiler``, its batch made
    before the trace: wall time, the device's busy time and share, its
    kernel launches, and the kernels that took most of it (device numbers
    None when the profiler saw no device activity: not measured)."""
    from torch.profiler import ProfilerActivity, profile

    batch = tr.stream.batch_at(step)
    g = torch.Generator(device="cuda").manual_seed(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.opt, _ = tr.step_fn(tr.opt, batch, g)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(r[1] for r in rows) / 1e3
    if not rows:
        return {"ms_traced": traced_ms, "device_busy_ms": None}
    return {"ms_traced": traced_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / traced_ms,
            "device_launches": sum(r[2] for r in rows),
            "top_device_kernels": [
                {"name": k[:60], "ms": us / 1e3, "launches": n}
                for k, us, n in rows[:8]]}


def phase_train_lm(cfg) -> None:
    """The training launcher's step on the card (``Trainer``: its RunConfig
    with the plain attention forms, ZipfLMStream, AdamW): TRAIN_STEPS steps
    at full width and depth in bf16, the loss must fall and stay finite;
    one checkpoint saved, restored on the CPU and compared bit for bit; the
    kernels' refusal of gradients probed; grad accumulation against one
    step at fp32 depth 4."""
    import shutil
    from dataclasses import replace

    from repro_torch.launch.train import Trainer, run_config
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, run_config(), seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                 lr=TRAIN_LR, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in tr.params.values())
    t0 = time.perf_counter()
    tr.stream.batch_at(0)
    data_s = time.perf_counter() - t0
    losses, gnorms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.step(i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(step_s[2:])[len(step_s[2:]) // 2]
    require(all(math.isfinite(x) for x in losses + gnorms),
            f"train: non-finite loss or grad norm: {losses} {gnorms}")
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")

    ck = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    writer = save_checkpoint(ck, TRAIN_STEPS, tr.state(), async_save=True)
    handed_back_s = time.perf_counter() - t0
    writer.join()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, at = restore_checkpoint(ck, None, tr.state(), device="cpu")
    restore_s = time.perf_counter() - t0
    require(at == TRAIN_STEPS, f"restored step {at}")
    same = [k for k, p in tr.params.items()
            if restored["params"][k].dtype == p.dtype
            and torch.equal(restored["params"][k], p.detach().cpu())]
    require(len(same) == len(tr.params),
            f"restored parameters differ: "
            f"{sorted(set(tr.params) - set(same))[:5]}")
    for k in tr.params:
        require(torch.equal(restored["opt"].mu[k], tr.opt.mu[k].cpu())
                and torch.equal(restored["opt"].nu[k], tr.opt.nu[k].cpu()),
                f"restored moments of {k} differ")
    require(int(restored["opt"].step) == TRAIN_STEPS, "restored AdamW step")
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(ck) for f in fs)
    shutil.rmtree(ck)
    profile = profile_train_step(tr, TRAIN_STEPS)
    del tr, restored
    gc.collect()
    torch.cuda.empty_cache()

    refused = probe_grad_refusal()
    accum = accum_equivalence(replace(cfg, n_layers=4, dtype="float32"))
    emit("train", config=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
         params=n_params, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, lr=TRAIN_LR, run=str(run_config()), losses=losses,
         grad_norms=gnorms, step_seconds=step_s, steady_ms_per_step=steady
         * 1e3, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady,
         data_seconds_per_batch=data_s, peak_memory_bytes=peak,
         checkpoint={"bytes": ckpt_bytes, "async_returned_s": handed_back_s,
                     "save_s": save_s, "restore_cpu_s": restore_s,
                     "params_bit_equal": True, "moments_bit_equal": True},
         refused_grad=refused, grad_accum=accum, profile=profile)


def phase_train_whisper(cfg) -> None:
    """One train step of whisper-small at full width (bf16), as
    tests/test_models_smoke.py::test_forward_and_train_step: the loss
    finite, the grad norm above 0, the parameters moved."""
    from repro_torch.models.api import RunConfig, build_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_train_step

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, RunConfig(attn_impl="plain"), device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    step = make_train_step(model, lr=1e-3)
    opt = adamw_init(dict(model.named_parameters()))
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, s = WHISPER_BATCH, 32
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"frames": torch.randn((b, model.enc_seq, cfg.d_model),
                                   generator=g, device="cuda").to(
                                       model.embed.dtype),
             "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt, m = step(opt, batch, g)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    moved = sum(int(not torch.equal(p, before[k]))
                for k, p in model.named_parameters())
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    emit("train-whisper", config=cfg.name, dtype=cfg.dtype, batch=b,
         seq=s, loss=loss, grad_norm=gnorm, params_moved=moved,
         params_total=len(before), step_seconds=step_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    require(math.isfinite(loss), f"train-whisper: loss {loss}")
    require(gnorm > 0, f"train-whisper: grad norm {gnorm}")
    require(moved > 0, "train-whisper: no parameter moved")
    del model, opt, before
    gc.collect()
    torch.cuda.empty_cache()


# -- phase: launch/serve --------------------------------------------------------

def phase_launch_serve() -> None:
    """The serve launcher at the reference's size (24 requests, 4 workers,
    the reduced model) at 40 requests a virtual second, so that the
    autoscaler starts several sandboxes: every request ok, and each one's
    tokens equal a solo replica drawn from the seed of the sandbox it was
    admitted to (each sandbox's replica has other weights)."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Replica

    out = serve.main(["--device", "cuda", "--rate", "40"])
    invs, backend = out["invocations"], out["backend"]
    require(out["ok"] == len(invs) == 24, f"launch/serve: {out['ok']}/"
            f"{len(invs)} ok")
    sids = {backend.sandbox_of[id(i.request)] for i in invs}
    require(len(sids) >= 2, f"launch/serve: one sandbox served all: {sids}")
    solo = {sid: Replica(out["cfg"], rng_seed=sid, max_seq=serve.MAX_SEQ,
                         device="cuda") for sid in sids}
    for i in invs:
        want = solo[backend.sandbox_of[id(i.request)]].generate(
            i.request.prompt, max_new_tokens=i.request.max_new_tokens)
        require(i.request.tokens == want,
                f"launch/serve: request {i.inv_id} was not served by its "
                f"sandbox's replica: {i.request.tokens} vs {want}")
    require(backend.replicas_live == 0 and backend.teardowns
            == out["replicas"], "launch/serve: replicas left after close")
    lats = sorted(i.e2e_latency for i in invs)
    emit("launch-serve", requests=len(invs), ok=out["ok"],
         sandboxes_served=len(sids), replicas=out["replicas"],
         teardowns=backend.teardowns, wall_s=out["wall_s"],
         e2e_virtual_p50_s=lats[len(lats) // 2], e2e_virtual_max_s=lats[-1],
         tokens_equal_own_sandbox=True)
    del solo
    torch.cuda.empty_cache()


# -- main -----------------------------------------------------------------------

SOURCES = {   # kernel -> (CUDA source, the TPU kernel it replaces)
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:82"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:102"),
    "wkv6": ("src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
             "src/repro/kernels/rwkv6_chunk.py:83"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "src/repro/kernels/ssd_chunk.py:80"),
}
# the kernels each path must launch
PATH_KERNELS = {"smollm-360m": ("decode_attention", "flash_attention"),
                "rwkv6-7b": ("wkv6",),
                "zamba2-2.7b": ("decode_attention", "flash_attention", "ssd"),
                "arctic-480b": ("decode_attention", "flash_attention"),
                "qwen2-vl-72b": ("decode_attention", "flash_attention"),
                # the parent's in-process replicas that check the children
                "smollm-360m/container": ("decode_attention",),
                "whisper-small": ("decode_attention", "flash_attention"),
                # training runs the plain forms: these must launch nothing
                "train/smollm-360m": (),
                "train/whisper-small": (),
                "launch/serve": ("decode_attention",)}
NO_KERNEL_PATHS = ("train/smollm-360m", "train/whisper-small")


def run_path(name, serve_records) -> dict:
    """One configuration's path, with the launch counters zeroed just
    before it and read just after it. Depth is full except where a leg says
    otherwise; weights are drawn from the seed. A serve phase's line goes
    into ``serve_records`` under its configuration's name."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    head, _, tail = name.partition("/")
    cfg = get_config(tail if head in ("train", "launch") else head) \
        if name != "launch/serve" else None
    ops.reset_launch_counts()
    if name == "smollm-360m":
        phase_model(cfg, fp32_depth=4)
        serve_records[name] = phase_serve(cfg)
    elif name == "rwkv6-7b":
        phase_model(cfg, fp32_depth=4, seq_chunk=64)
        phase_serve(cfg, reused_probe=True)
    elif name == "zamba2-2.7b":
        # fp32 depth 12: two super-blocks, so the shared attention runs at
        # two invocation points with two KV caches (depth is a multiple of
        # attn_every = 6)
        phase_model(cfg, fp32_depth=12, init_kw={"layer_fan_in": True},
                    seq_chunk=64)
        phase_generate(cfg)
    elif name == "arctic-480b":
        # a layer is ~27.2 GB in bf16 (its 128 experts 26.8): depth 2 in
        # bf16 and 1 in fp32 is what 80 GB holds; serve keeps one replica
        # alive at a time
        phase_model(cfg, fp32_depth=1, bf16_depth=2)
        phase_serve(replace(cfg, n_layers=2), max_scale=1,
                    full_depth=cfg.n_layers)
    elif name == "qwen2-vl-72b":
        phase_model(cfg, fp32_depth=2, bf16_depth=8)
    elif name == "smollm-360m/container":
        phase_container(cfg, serve_records["smollm-360m"])
    elif name == "whisper-small":
        phase_whisper(cfg)
    elif name == "train/smollm-360m":
        phase_train_lm(cfg)
    elif name == "train/whisper-small":
        phase_train_whisper(cfg)
    else:
        phase_launch_serve()
    counts = ops.launch_counts()
    for k in PATH_KERNELS[name]:
        require(counts[k] > 0, f"{name}: the path never launched {k}")
    if name in NO_KERNEL_PATHS:
        require(not any(counts.values()),
                f"{name}: training launched kernels: {counts}")
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    gpu = phase_env()
    phase_build()
    timed = phase_kernels()

    # each path starts with the counters at 0 and is read when it ends, so
    # the comparisons above do not count
    serve_records = {}
    paths = {name: run_path(name, serve_records) for name in PATH_KERNELS}
    emit("launches", paths=paths)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rec = timed[name]
        launches = sum(p[name] for p in paths.values())
        require(launches > 0, f"{name}: no path launched the kernel")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"],
            **{k: rec[k] for k in ("bound_3xtf32_ms", "bound_3xtf32_by")
               if k in rec}})
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
