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
           ``ms_third``) for the spread; the grouped GEMM (the MoE's
           ``lax.ragged_dot``) at arctic-480b's and kimi-k2's decode steps
           (gate and down) and arctic's prefill, and the fused gate/up pass
           (``grouped_swiglu``: two of them and silu(g) u) at the three gate
           shapes, fp32 and bf16, at empty groups, one group, a group of
           more rows than a pass holds, rows past the last group (exactly
           0), K not a multiple of 8, and eager against graph replay, with
           ``torch._grouped_mm`` (twice, and the epilogue, for the fused
           pass) timed beside them and each timed row's share of its byte
           bound; the WKV6 decode step (one token, in place in the cache)
           at rwkv6-7b's captured step, a reduced RWKV6's and one mesh
           rank's heads, with rows at length 0 whose stale (NaN) state must
           not leak, every head size up to 128, the other layers' slices
           untouched, and eager against graph replay, within 1e-5 / 1e-6
           of its plain form, timed over the 32 layers of a step
  designs  the recurrence kernels' other block shapes (``design`` of the
           wrappers) at the main paths' shapes, timed in turns

then twelve paths, each driven with the launch counters zeroed just
before it and read just after it (as every path below is). Every
``Replica`` decodes by replaying the CUDA graph of its decode step that
``ExecutableCache.warm`` captured (two eager warm-up steps, the last under
CUDA's sync debug mode "error", then the capture); a serve path checks
that every replica it created was captured, counts launches as the eager
warm-up steps plus the replays (a replay adds what its capture counted),
and its ``steady_state`` holds the captured step against ``decode_step``
run eagerly on a copy of the same cache (logits and cache bit for bit),
beside the eager step's time and host syncs:

  smollm-360m  model: full-width prefill forward (flash-attention kernel)
               against token-by-token decode (flash-decode kernel) and
               against the same model on its plain attention, bf16 at full
               depth and fp32 at cut depth; serve: Cluster -> DataPlane ->
               WorkerDaemon -> LiveBackend -> ContinuousBatcher ->
               DecoderLM.decode_step, 16 requests, the launch counters
               accounting for every step; cache_owners: a batcher's 8
               requests alone, then again with a ``generate`` and a second
               batcher of the same batch size coming in after 4 steps on
               the same replica, tokens equal (each ``new_cache`` its own
               captured executable)
  rwkv6-7b     model: the same legs at full width (forward on the WKV6
               kernel, decode on the WKV6 decode step); serve: the same
               path and traffic into RWKV6Model.decode_step (a replay
               launches the decode step once a layer), plus one probe
               request admitted into a slot that has served before, whose
               tokens must equal the same request alone in a batcher of
               as many slots on its sandbox's weights
  zamba2-2.7b  model: the same legs at full width (forward on the SSD and
               flash-attention kernels at head_dim 80, decode on the
               flash-decode kernel), the Mamba matrices drawn at their
               per-layer fan-in; generate: Replica.generate twice on the
               same weights through the captured batch-1 step, equal greedy
               tokens, one more step against the eager one
  arctic-480b  the MoE family (128 experts, top-2, dense residual) at full
               width, depth cut to what 80 GB holds (printed in each line):
               model legs (bf16 at depth 2, fp32 at depth 1) on K2 and K1 at
               head_dim 128 with 56/8 heads and the grouped GEMM, the plain
               twin (the loop over the groups) sharing the kernel model's
               tensors; serve: the smollm traffic through the same path
               into one replica at a time (max_scale 1), the probe against
               a solo replica built after the backend is gone; every
               serve step launches ``grouped_swiglu`` and ``grouped_matmul``
               once a layer, and the steady state records each grouped
               launch of a captured step (device ms, active experts, share
               of their byte bound)
  kimi-k2-1t-a32b
               the MoE family at 384 experts, top-8, 64/8 heads, vocab
               163840, at full width and depth 1 in bf16 (38.8 GB; fp32
               would not fit): the bf16 model leg and the serve leg as
               arctic's, the grouped GEMM at 384 experts and C = 64 in
               every captured step
  qwen2-vl-72b the vlm family (M-RoPE, text-only positions) at full width:
               model legs, bf16 at depth 8 and fp32 at depth 2
  smollm-360m/container
               the smollm traffic with LiveBackend(mode="container"): one
               worker process per sandbox, the kernel library built into a
               fresh build directory by the first (cold) creation and loaded
               by the later (warm) ones; every request's tokens against an
               in-process replica with its sandbox's seed, which runs (and
               counts) the flash-decode kernel through its captured step
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
               the training launcher's step (plain attention forms, remat
               on, AdamW, ZipfLMStream) at full width and depth in bf16:
               20 steps of the default ``Trainer``, which captures its step
               as a CUDA graph (two warm steps, then replays), each step
               bit-equal to an eager twin's (loss, parameters, moments,
               step), the loss must fall; ms a step captured and eager,
               the replay's launches and busy share (``torch.profiler``); a
               remat-off leg of 3 eager steps must allocate more a step; a
               checkpoint saved and restored on the CPU bit for bit; every
               kernel wrapper handed a grad-requiring CUDA input must
               refuse it; grad accumulation against one step at fp32 depth
               4 (on per-layer fan-in weights; the reference's init
               recorded beside), and through the executable, bit-equal to
               eager. Its kernel counters must read 0
  train/whisper-small
               one eager train step at full width (bf16): finite loss,
               grad norm above 0, parameters moved; its kernel counters
               must read 0
  launch/serve the serve launcher (24 requests, 4 workers, the reduced
               model) at 400 requests a virtual second: every request ok,
               each one's tokens equal to a solo replica of the sandbox it
               was admitted to
  churn-live/smollm-360m
               the live churn bench (``benchmarks/torch_churn_live.py``) at
               full width: its process-mode cold/warm point (one cold
               creation, four warm, each split into the replica's build
               and its capture) and its first grid cell (8 workers, 100
               requests over 8 functions, 4-token prompts, 8 new tokens);
               every creation succeeds and is captured, every request is
               done with its tokens (the first and the last equal to a
               solo replica's with their sandbox's seed), no replica
               leaks, and the device memory is back within 256 MB after
               the backends close

and then the mesh paths, four ranks each, all processes on ``cuda:0`` over
gloo, each held against the port on one device with the same weights
(run first and freed before the ranks start):

  mesh/qwen3-32b, mesh/smollm-360m, mesh/arctic-480b,
  mesh/train-smollm-360m
               tensor-parallel prefill and sequence-sharded decode (smollm's
               15 heads padded to 16; both models in one spawn); expert-
               parallel and FSDP MoE; data-parallel training with ZeRO-1
               and a resume onto another mesh (the comments there say more)
  mesh/rwkv6-7b, mesh/zamba2-2.7b, mesh/whisper-small
               each family tensor-parallel on (1, 4) at full width, an fp32
               cut gated at 1e-4 and a bf16 cut at 0.5: K3 at 16 of 64
               heads; K4 at 20 of 80 SSD heads behind the resharded
               in_proj, K2 and K1 at 8 of 32 heads of 80, batch 2 on the
               replicated KV cache and batch 1 on the head-sharded one; K2
               and K1 at 3 of 12 heads with the caches replicated. The
               three run in one spawn, each rank zeroing its counters
               before a family and reading them after it
  mesh/zamba2-2.7b-b1
               Zamba2 with a batch of 1 on (2, 2), in the same spawn: the
               KV cache's sequence split over the data axis (the decode
               steps write across the ranks' boundary), its heads and the
               SSD heads over the model axis, with the (1, 4) legs' controls
  mesh/train-qwen3-32b
               the train step tensor-parallel at full width in fp32 (depth
               1) on (1, 4), and on (2, 2) with ZeRO-1: losses and the
               step-1 parameters against one device; no kernel

then a ``roofline`` line: every timed mesh leg's collectives a step against
the dry run's count of the same step on meta tensors (``launch/dryrun.py``;
they must be equal), and the counted compute and memory terms of smollm's
serve and train steps and qwen3's one-device decode beside their measured
times; then one ``{"kernels": [...]}`` line (per kernel: launches on the paths,
error, time, plain time, library time, bound; for WKV6 and SSD also the
3xTF32 bound), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

Tolerances. A kernel against its plain version on the same inputs: 2e-5 in
fp32 (both accumulate in fp32; only the summation order differs) and 2e-2 in
bf16 (one bf16 rounding of an output of magnitude <= ~4; the fused
gate/up pass, whose silu(g) u reaches ~10, as an allclose with atol = rtol,
as the CPU tests hold it against the reference); the recurrences
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

import contextlib
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
sys.path.insert(0, ROOT)                 # the benchmarks package

import torch  # noqa: E402

# the kernels' main cases and their timing, shared with the kernel bench
from benchmarks.torch_kernel_bench import (  # noqa: E402
    DECODE_LAYERS, FLASH_CALLS, MAIN, RAGGED, SEED, add_rms_norm_cost, bound,
    decode_cost, decode_inputs, device_ms, flash_cost, flash_inputs,
    grouped_cost, grouped_inputs, grouped_library, moe_group_sizes,
    norm_inputs, rope_inputs, rope_kv_write_cost, sdpa_decode, sdpa_prefill,
    silu_inputs, silu_mul_cost, ssd_card_inputs, ssd_cost, swiglu_library,
    time_ms, wkv6_card_inputs, wkv6_cost, wkv6_decode_cost,
    wkv6_decode_inputs)
from repro_torch.launch import roofline  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): the
# dry run's roofline and the kernel bounds here read the same constants
HBM_BYTES_PER_S = roofline.HBM_BW
# the tensor cores in TF32; a 3xTF32 product is 3 of them
TF32_FLOPS = roofline.peak_flops("tf32")
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RECURRENCE_TOL = {dt: 5 * tol for dt, tol in KERNEL_TOL.items()}

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


def dt_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


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

def bound_3xtf32(nbytes, product_flops):
    """The bound of the arithmetic the recurrence kernels run: their
    products as three TF32 products each on the tensor cores, against the
    bytes."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 3 * product_flops / TF32_FLOPS * 1e3
    return {"bound_3xtf32_ms": max(by_bytes, by_ops),
            "bound_3xtf32_by": "bytes" if by_bytes >= by_ops
            else "operations"}


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
        nbytes, flops = decode_cost(B, Smax, Hq, Hkv, D, lens,
                                    q.element_size())
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
                                                 dtype))
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


def check_flash(name, B, Sq, Skv, Hq, Hkv, D, dtype, causal, q_offset=0,
                timed=False, zero_heads=0):
    """Kernel vs plain on one prefill shape (``zero_heads``: the last query
    heads all zeros, as a padding head's are). Timed: ``ms`` and
    ``library_ms`` from FLASH_CALLS calls a graph, ``profiled_ms`` and
    ``library_profiled_ms`` the device time ``torch.profiler`` records for
    one call."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    q, k, v = flash_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed=SEED + 1)
    if zero_heads:
        q[:, :, Hq - zero_heads:] = 0
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
        nbytes, flops = flash_cost(B, Sq, Skv, Hq, Hkv, D, causal, q_offset,
                                   q.element_size())

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
            return sdpa_prefill(q, k, v, causal)

        rec.update(
            ms=device_ms(calls(one_kernel), FLASH_CALLS),
            plain_ms=device_ms(calls(one_plain), FLASH_CALLS, reps=5),
            eager_ms=time_ms(one_kernel),
            eager_plain_ms=time_ms(one_plain, reps=5, warmup=1),
            ms_one_call_graph=device_ms(one_kernel),
            library_ms=None, **bound(nbytes, flops, dtype))
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

    r, k, v, w, u, s0 = wkv6_card_inputs(B, S, H, dk, dv, dtype, SEED + 3,
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
        nbytes, flops, products = wkv6_cost(B, S, H, dk, dv, chunk,
                                            r.element_size())

        def run_kernel():
            return wkv6(r, k, v, w, u, s0, chunk=chunk)

        def run_plain():
            return wkv6_plain(r, k, v, w, u, s0, chunk=chunk)

        rec.update(bound(nbytes, flops, dtype))
        rec.update(bound_3xtf32(nbytes, products))
        rec.update(ms=device_ms(run_kernel), plain_ms=device_ms(run_plain,
                                                                reps=5),
                   eager_ms=time_ms(run_kernel),
                   eager_plain_ms=time_ms(run_plain, reps=5, warmup=1),
                   library_ms=None,
                   library_note="no PyTorch call computes WKV6")
        rec["ms_again"] = device_ms(run_kernel)
        rec["ms_third"] = device_ms(run_kernel)
    return rec


# the WKV6 decode step against its plain form: both fp32 FMAs in another
# order, so an allclose at these (no TF32 on either side)
DECODE_STEP_RTOL, DECODE_STEP_ATOL = 1e-5, 1e-6
# a freed slot's stale state, as the plain form reads it (it multiplies by
# 0, so NaN would stay NaN); the kernel, which must not read it, gets NaN
STALE = 1e6


def step_excess(got, want) -> float:
    """max(|got - want| - atol - rtol |want|): <= 0 is an allclose at the
    decode step's tolerances."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - DECODE_STEP_ATOL
                  - DECODE_STEP_RTOL * want.abs()).max())


def check_wkv6_decode(name, B, H, dk, dv, dtype, lens=None, timed=False,
                      scalar_len=None):
    """The WKV6 decode step on the middle layer of a three-layer cache
    against its plain form on a copy: y and the new state within
    DECODE_STEP_RTOL / ATOL, the state written in the cache's own storage
    and the other layers' slices untouched. ``lens`` (default: every row
    continuing) may hold 0s: such a row's slice holds NaN in the kernel's
    cache and STALE in the plain form's, and must come out as a start from
    zero state. ``scalar_len`` passes one length for every row."""
    from repro_torch.kernels import ops

    r, k, v, w, u, states, lens_t = wkv6_decode_inputs(B, H, dk, dv, dtype,
                                                       3, SEED + 5)
    if lens is not None:
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cache_len = lens_t if scalar_len is None else scalar_len
    starts = (lens_t == 0) if scalar_len is None \
        else torch.full((B,), scalar_len == 0, device="cuda")
    plain_cache = states.clone()
    plain_cache[1][starts] = STALE
    states[1][starts] = float("nan")
    before = states.clone()
    slot = states[1]
    ptr = slot.data_ptr()
    y = ops.wkv6_decode(r, k, v, w, u, slot, cache_len)
    want_y = ops.wkv6_decode(r, k, v, w, u, plain_cache[1], cache_len,
                             impl="plain")
    torch.cuda.synchronize()
    zero_y = ops.wkv6_decode(r, k, v, w, u, torch.zeros_like(slot), 1,
                             impl="plain")
    rec = {"case": name, "kernel": "wkv6_decode",
           "shape": {"B": B, "H": H, "dk": dk, "dv": dv},
           "dtype": dt_name(dtype), "rows_at_length_0": int(starts.sum()),
           "scalar_len": scalar_len,
           "max_abs_err": max_abs_err(y, want_y),
           "state_max_abs_err": max_abs_err(slot, plain_cache[1]),
           "allclose_excess": max(step_excess(y, want_y),
                                  step_excess(slot, plain_cache[1])),
           "rtol": DECODE_STEP_RTOL, "atol": DECODE_STEP_ATOL,
           "in_place": slot.data_ptr() == ptr,
           "other_layers_untouched": bool(
               torch.equal(states[0], before[0])
               and torch.equal(states[2], before[2]))}
    if starts.any():
        rec["started_rows_excess_vs_zero_state"] = step_excess(
            y[starts], zero_y[starts])
    for t in (y, slot):
        require(bool(torch.isfinite(t).all()), f"{name}: not finite")
    require(rec["allclose_excess"] <= 0,
            f"{name}: outside allclose(rtol={DECODE_STEP_RTOL}, "
            f"atol={DECODE_STEP_ATOL}): {rec}")
    require(rec["in_place"] and rec["other_layers_untouched"],
            f"{name}: the cache was not written in place alone: {rec}")
    require(rec.get("started_rows_excess_vs_zero_state", 0.0) <= 0,
            f"{name}: a row at length 0 did not start from zero: {rec}")
    if timed:
        L = DECODE_LAYERS
        del states, plain_cache, before
        *_, cache, lens_t = wkv6_decode_inputs(B, H, dk, dv, dtype, L,
                                               SEED + 5)

        def each(impl):
            return lambda: [ops.wkv6_decode(r, k, v, w, u, cache[i], lens_t,
                                            impl=impl) for i in range(L)]

        nbytes, flops = wkv6_decode_cost(B, H, dk, dv, r.element_size())
        rec.update(bound(nbytes, flops, torch.float32))
        rec.update(layers=L, ms=device_ms(each("kernel"), L),
                   plain_ms=device_ms(each("plain"), L, reps=5),
                   eager_ms=time_ms(each("kernel"), L),
                   library_ms=None,
                   library_note="no PyTorch call computes WKV6")
        rec["ms_again"] = device_ms(each("kernel"), L)
        rec.update(step_ms=rec["ms"] * L, plain_step_ms=rec["plain_ms"] * L,
                   bound_step_ms=rec["bound_ms"] * L,
                   bound_share=rec["bound_ms"] / rec["ms"])
        del cache
        torch.cuda.empty_cache()
    return rec


def check_wkv6_decode_graph(name, B, H, dk, dv, dtype):
    """The decode step eagerly, then captured into a CUDA graph and
    replayed, each from the same cache: y and the new state bit-equal (no
    atomics, no data-dependent order), the replay writing the captured
    slice in place."""
    from repro_torch.kernels import ops

    r, k, v, w, u, states, lens = wkv6_decode_inputs(B, H, dk, dv, dtype, 1,
                                                     SEED + 7)
    lens[::3] = 0
    start = states.clone()
    y_eager = ops.wkv6_decode(r, k, v, w, u, states[0], lens).clone()
    s_eager = states.clone()
    states.copy_(start)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_static = ops.wkv6_decode(r, k, v, w, u, states[0], lens)
    states.copy_(start)
    graph.replay()
    torch.cuda.synchronize()
    equal = [torch.equal(y_static, y_eager), torch.equal(states, s_eager)]
    rec = {"case": name, "kernel": "wkv6_decode", "dtype": dt_name(dtype),
           "y_and_state_eager_vs_graph_bit_equal": equal}
    require(all(equal), f"{name}: eager and replay differ: {equal}")
    return rec


# -- the decode step's fused passes ----------------------------------------------
#
# Each kernel against its plain form (the composition it replaces) on the
# same inputs: what both round alike must be bit-equal (the norm's residual
# add; the rotation, whose fp32 products and sums the kernel rounds one by
# one as PyTorch's separate kernels do; the cache rows no row writes), the
# rest within allclose(atol = rtol = KERNEL_TOL): the norm's sum of squares
# runs in another order, and silu's exp is the device's expf on both sides
# but may differ in its last bit from PyTorch's.

def _timed_fused(rec, kernel, plain, cost, dtype, calls=DECODE_LAYERS):
    """``calls`` calls a timed graph, one a layer of a step."""
    rec.update(bound(*cost, dtype))
    rec.update(layers=calls,
               ms=device_ms(lambda: [kernel() for _ in range(calls)], calls),
               plain_ms=device_ms(lambda: [plain() for _ in range(calls)],
                                  calls, reps=5),
               eager_ms=time_ms(lambda: [kernel() for _ in range(calls)],
                                calls),
               library_ms=None,
               library_note="no one PyTorch call computes the pass")
    rec["ms_again"] = device_ms(lambda: [kernel() for _ in range(calls)],
                                calls)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def check_add_rms_norm(name, B, d, dtype, delta=True, timed=False):
    """The residual add and RMSNorm against ``x + delta`` then
    ``layers.rms_norm``: the residual bit-equal, the norm's output within
    allclose(KERNEL_TOL); without ``delta`` (a first layer) the kernel hands
    x back."""
    from repro_torch.kernels import ops

    x, dl, w = norm_inputs(B, d, dtype, SEED + 21)
    dl = dl if delta else None
    got_x, got_h = ops.add_rms_norm(x, dl, w)
    want_x, want_h = ops.add_rms_norm(x, dl, w, impl="plain")
    torch.cuda.synchronize()
    tol = KERNEL_TOL[dtype]
    rec = {"case": name, "kernel": "add_rms_norm",
           "shape": {"B": B, "d": d, "delta": delta}, "dtype": dt_name(dtype),
           "residual_bit_equal": bool(torch.equal(got_x, want_x)),
           "x_handed_back": got_x is x,
           "max_abs_err": max_abs_err(got_h, want_h),
           "bit_equal": bool(torch.equal(got_h, want_h)),
           "allclose_excess": allclose_excess(got_h, want_h, tol), "tol": tol}
    require(bool(torch.isfinite(got_h.float()).all()), f"{name}: not finite")
    require(rec["residual_bit_equal"] and (delta or rec["x_handed_back"]),
            f"{name}: the residual differs from x + delta: {rec}")
    require(rec["allclose_excess"] <= tol,
            f"{name}: outside allclose(atol=rtol={tol}): {rec}")
    if timed:
        _timed_fused(rec, lambda: ops.add_rms_norm(x, dl, w),
                     lambda: ops.add_rms_norm(x, dl, w, impl="plain"),
                     add_rms_norm_cost(B, d, x.element_size(), delta), dtype)
    return rec


def check_rope_kv_write(name, B, Smax, Hq, Hkv, D, dtype, lens=None,
                        mrope=None, timed=False):
    """The rotation and KV write against ``layers.rotate`` then
    ``index_put_`` on a copy of the caches: the rotated q and both caches
    bit-equal (every position but each row's own untouched), else within
    allclose(KERNEL_TOL). ``lens`` may hold 0s and any stale length."""
    from repro_torch.kernels import ops

    q, k, v, cos, sin, ck, cv, pos = rope_inputs(B, Smax, Hq, Hkv, D, dtype,
                                                 SEED + 22, lens, mrope)
    pk, pv = ck.clone(), cv.clone()
    before = ck.clone()
    got = ops.rope_kv_write(q, k, v, cos, sin, ck, cv, pos)
    want = ops.rope_kv_write(q, k, v, cos, sin, pk, pv, pos, impl="plain")
    torch.cuda.synchronize()
    tol = KERNEL_TOL[dtype]
    own = torch.zeros((B, Smax), dtype=torch.bool, device="cuda")
    own[torch.arange(B, device="cuda"), pos] = True
    moved = (ck != before).any(-1).any(-1)
    rec = {"case": name, "kernel": "rope_kv_write",
           "shape": {"B": B, "Smax": Smax, "Hq": Hq, "Hkv": Hkv, "D": D,
                     "mrope": mrope},
           "dtype": dt_name(dtype), "rows_at_length_0": int((pos == 0).sum()),
           "max_abs_err": max(max_abs_err(got, want), max_abs_err(ck, pk),
                              max_abs_err(cv, pv)),
           "bit_equal": [bool(torch.equal(got, want)),
                         bool(torch.equal(ck, pk)), bool(torch.equal(cv, pv))],
           "allclose_excess": max(allclose_excess(got, want, tol),
                                  allclose_excess(ck, pk, tol),
                                  allclose_excess(cv, pv, tol)),
           "only_own_rows_written": not bool((moved & ~own).any()),
           "tol": tol}
    require(rec["allclose_excess"] <= tol,
            f"{name}: outside allclose(atol=rtol={tol}): {rec}")
    require(rec["only_own_rows_written"],
            f"{name}: the kernel wrote outside its rows' positions: {rec}")
    if timed:
        _timed_fused(rec, lambda: ops.rope_kv_write(q, k, v, cos, sin, ck, cv,
                                                    pos),
                     lambda: ops.rope_kv_write(q, k, v, cos, sin, pk, pv, pos,
                                               impl="plain"),
                     rope_kv_write_cost(B, Hq, Hkv, D, q.element_size()),
                     dtype)
    return rec


def check_silu_mul(name, B, d_ff, dtype, timed=False):
    """silu(g) * u against ``F.silu(g) * u``, within allclose(KERNEL_TOL)."""
    from repro_torch.kernels import ops

    gate, up = silu_inputs(B, d_ff, dtype, SEED + 23)
    got = ops.silu_mul(gate, up)
    want = ops.silu_mul(gate, up, impl="plain")
    torch.cuda.synchronize()
    tol = KERNEL_TOL[dtype]
    rec = {"case": name, "kernel": "silu_mul",
           "shape": {"B": B, "d_ff": d_ff}, "dtype": dt_name(dtype),
           "max_abs_err": max_abs_err(got, want),
           "bit_equal": bool(torch.equal(got, want)),
           "allclose_excess": allclose_excess(got, want, tol), "tol": tol}
    require(rec["allclose_excess"] <= tol,
            f"{name}: outside allclose(atol=rtol={tol}): {rec}")
    if timed:
        _timed_fused(rec, lambda: ops.silu_mul(gate, up),
                     lambda: ops.silu_mul(gate, up, impl="plain"),
                     silu_mul_cost(B, d_ff, gate.element_size()), dtype)
    return rec


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

    x, dt, A, Bm, Cm, D, h0 = ssd_card_inputs(b, S, H, P, N, dtype, broadcast,
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
        nbytes, flops, products = ssd_cost(b, S, H, P, N, chunk,
                                           x.element_size(), broadcast)

        def run_kernel():
            return ssd(x, dt, A, Bm, Cm, D, h0, chunk=chunk)

        def run_plain():
            return ssd_plain(x, dt, A, Bm, Cm, D, h0, chunk=chunk)

        rec.update(bound(nbytes, flops, dtype))
        rec.update(bound_3xtf32(nbytes, products))
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
        args = wkv6_card_inputs(1, 256, 64, 64, 64, dtype, SEED + 7)

        def call():
            return wkv6(*args, chunk=64)
    else:
        dtype = torch.float32
        args = ssd_card_inputs(1, 256, 80, 64, 64, dtype, True, SEED + 8)

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
        args = wkv6_card_inputs(1, 256, 64, 64, 64, torch.bfloat16, SEED + 3)

        def call(d):
            return wkv6(*args, chunk=64, design=d)
    else:
        x, dt, A, Bm, Cm, D, h0 = ssd_card_inputs(1, 256, 80, 64, 64,
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


LSE_TOL = 1e-4   # K1's lse against the plain one: fp32 sums on both sides


def check_decode_lse(name, B, Smax, Hq, Hkv, D, dtype, lens, timed=False,
                     plan=None):
    """K1 with ``return_lse`` against its plain version on the same inputs:
    the output within KERNEL_TOL and bit-equal to the default call's, the
    rows' log-sum-exp within LSE_TOL (both fp32 sums of the same fp32
    scores, in other orders), -inf exactly where a row has no position.
    ``plan`` forces a split of the KV axis (the merge's lse). With
    ``timed``, the kernel's device time with and without the lse over 32
    caches, as one decode step walks them."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      split_plan)

    n_layers = 32 if timed else 1
    q, kc, vc, lens_t = decode_inputs(B, Smax, Hq, Hkv, D, dtype, lens,
                                      n_layers, seed=SEED + 9)
    out, lse = decode_attention(q[0], kc[0], vc[0], lens_t, plan=plan,
                                return_lse=True)
    default = decode_attention(q[0], kc[0], vc[0], lens_t, plan=plan)
    want, want_lse = decode_attention_plain(q[0], kc[0], vc[0], lens_t,
                                            return_lse=True)
    torch.cuda.synchronize()
    empty = torch.isinf(want_lse)
    err = max_abs_err(out, want)
    lse_err = max_abs_err(torch.where(empty, 0.0, lse),
                          torch.where(empty, 0.0, want_lse))
    rec = {"case": name, "kernel": "decode_attention", "return_lse": True,
           "shape": {"B": B, "Smax": Smax, "Hq": Hq, "Hkv": Hkv, "D": D},
           "dtype": str(dtype).replace("torch.", ""), "lens": lens,
           "plan": plan or split_plan(
               B, Hq, Hkv, Smax,
               torch.cuda.get_device_properties(0).multi_processor_count),
           "max_abs_err": err, "tol": KERNEL_TOL[dtype],
           "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
           "default_call_bit_equal": bool(torch.equal(out, default))}
    require(rec["default_call_bit_equal"],
            f"{name}: the call with lse changed the output")
    require(err <= KERNEL_TOL[dtype], f"{name}: max_abs_err {err}")
    require(bool(torch.equal(torch.isinf(lse), empty)
                 and (lse[empty] < 0).all()),
            f"{name}: -inf rows differ")
    require(lse_err <= LSE_TOL, f"{name}: lse max_abs_err {lse_err}")
    if timed:
        nbytes, flops = decode_cost(B, Smax, Hq, Hkv, D, lens,
                                    q.element_size())

        def run(with_lse):
            for i in range(n_layers):
                decode_attention(q[i], kc[i], vc[i], lens_t,
                                 return_lse=with_lse)

        rec.update(ms=device_ms(lambda: run(True), n_layers),
                   ms_without_lse=device_ms(lambda: run(False), n_layers),
                   ms_again=device_ms(lambda: run(True), n_layers),
                   **bound(nbytes + 4 * B * Hq, flops, dtype))
    return rec


def check_grouped(name, C, K, N, E, sizes, dtype, timed=False,
                  graph=False, fused=False):
    """The grouped GEMM (``lax.ragged_dot``), or with ``fused`` the fused
    gate/up pass (two of them and ``silu(g) * u``), against its plain
    version, the loop over the groups. With ``timed``, ``ms`` is device
    time (a graph of the kernel's launches), ``eager_ms`` the kernel called
    from Python, and ``plain_ms`` the plain version called from Python: it
    reads the sizes on the host, so it cannot be captured, and its time
    includes that wait. The weights are 1-18 GB a matrix, far past L2, so
    every launch reads them cold as the model's does. ``graph``: two eager
    calls and two graph replays bit-equal."""
    from repro_torch.kernels import grouped_gemm as G

    x, ws = grouped_inputs(C, K, N, E, dtype, fused, SEED + 11)
    gs = torch.tensor(sizes, dtype=torch.int64, device="cuda")
    if fused:
        kernel, lib = "grouped_swiglu", swiglu_library
        run, plain = G.grouped_swiglu, G.grouped_swiglu_plain
    else:
        kernel, lib = "grouped_matmul", grouped_library
        run, plain = G.grouped_matmul, G.grouped_matmul_plain
    got = run(x, *ws, gs)
    want = plain(x, *ws, gs)
    torch.cuda.synchronize()
    err, tol = max_abs_err(got, want), KERNEL_TOL[dtype]
    rows = int(sum(sizes))
    rec = {"case": name, "kernel": kernel,
           "shape": {"C": C, "K": K, "N": N, "E": E},
           "dtype": dt_name(dtype), "rows": rows,
           "active_experts": sum(1 for n in sizes if n),
           "max_abs_err": err, "tol": tol,
           "rows_past_last_group_zero": bool((got[rows:] == 0).all())}
    require(bool(torch.isfinite(got.float()).all()), f"{name}: not finite")
    if fused:
        # silu(g) u reaches |h| ~ 10 here, where one bf16 ulp is 0.03-0.06,
        # and a g or u one ulp off (another order of the fp32 sum) moves h
        # by |u| ulp(g): an allclose with atol = rtol = tol, as the CPU
        # tests hold this op against lax.ragged_dot
        rec["allclose_excess"] = allclose_excess(got, want, tol)
        require(rec["allclose_excess"] <= tol,
                f"{name}: not allclose at {tol}: excess "
                f"{rec['allclose_excess']} (max_abs_err {err})")
    else:
        require(err <= tol, f"{name}: max_abs_err {err} > {tol}")
    require(rec["rows_past_last_group_zero"],
            f"{name}: rows past the last group are not 0")
    if graph:
        outs = [run(x, *ws, gs).clone() for _ in range(2)]
        torch.cuda.synchronize()
        cg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cg):
            static = run(x, *ws, gs)
        for _ in range(2):
            cg.replay()
            torch.cuda.synchronize()
            outs.append(static.clone())
        rec["eager_eager_graph_graph_bit_equal"] = [
            bool(torch.equal(outs[0], o)) for o in outs]
        require(all(rec["eager_eager_graph_graph_bit_equal"]),
                f"{name}: eager and replayed outputs differ")
    if timed:
        nbytes, flops = grouped_cost(C, K, N, E, sizes, len(ws),
                                     x.element_size())
        rec.update(ms=device_ms(lambda: run(x, *ws, gs)),
                   eager_ms=time_ms(lambda: run(x, *ws, gs)),
                   plain_ms=time_ms(lambda: plain(x, *ws, gs), reps=5,
                                    warmup=1),
                   **bound(nbytes, flops, dtype))
        rec["ms_again"] = device_ms(lambda: run(x, *ws, gs))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["library_ms"] = rec["library_error"] = None
        if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
            try:
                ref = lib(x, *ws, gs)
                torch.cuda.synchronize()
                rec["library_max_abs_err"] = max_abs_err(ref[:rows],
                                                         want[:rows])
                rec["library_ms"] = device_ms(lambda: lib(x, *ws, gs))
            except Exception as e:   # the yardstick only: record why not
                rec["library_error"] = repr(e)[:300]
        elif dtype != torch.bfloat16:
            rec["library_error"] = "torch._grouped_mm takes bf16 only"
        else:
            rec["library_error"] = "this torch has no torch._grouped_mm"
    del x, ws, got, want
    torch.cuda.empty_cache()
    return rec


def phase_kernels() -> dict:
    """Returns the timed main-path records, by kernel name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # K1 at the main path's shape: one ContinuousBatcher step of
        # smollm-360m, 8 slots, 1024-long cache, per-slot lengths
        check_decode("decode/main/bf16", **MAIN["decode_attention"],
                     timed=True, split=True,
                     plans=[(1, 1024), (8, 128), (16, 64)]),
        check_decode("decode/main/fp32", 8, 1024, 15, 5, 64, f32, RAGGED,
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
                           bf16, RAGGED),
        # K2 at the main path's shape (the 256-token prefill of the model
        # phase) and at the sizes named for it
        check_flash("flash/main/bf16", **MAIN["flash_attention"],
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
        # step (8 slots, RAGGED) and at qwen2-vl's last decode step of the
        # model phase (256 cached positions), K2 at the 256-token prefill.
        # Beside arctic's K1, the same cache with a group of 8: what the
        # group of 7 costs
        check_decode("decode/arctic-g7-d128/bf16", 8, 1024, 56, 8, 128, bf16,
                     RAGGED, timed=True),
        check_decode("decode/arctic-g7-d128/fp32", 8, 1024, 56, 8, 128, f32,
                     RAGGED, timed=True),
        check_decode("decode/g8-d128-arctic-batch/bf16", 8, 1024, 64, 8, 128,
                     bf16, RAGGED, timed=True),
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
        # K1 with the rows' log-sum-exp, at the shard of the mesh/qwen3-32b
        # path's sequence-sharded decode: all 64 query heads against one
        # rank's 256 of the 1024 positions; rows of length 0 (a rank past
        # the cache's end), the split path's merge, a long split row
        check_decode_lse("decode-lse/qwen3-shard/bf16", 2, 256, 64, 8, 128,
                         bf16, [0, 177], timed=True),
        check_decode_lse("decode-lse/qwen3-shard/fp32", 2, 256, 64, 8, 128,
                         f32, [256, 0], timed=True),
        check_decode_lse("decode-lse/split/bf16", 2, 256, 64, 8, 128, bf16,
                         [0, 177], plan=(2, 128)),
        check_decode_lse("decode-lse/split/fp32", 4, 2048, 15, 5, 64, f32,
                         [0, 100, 1500, 2048]),
        # K1-K4 at the shapes one rank of the family mesh paths gives them
        # on (1, 4), in both dtypes the legs run: rwkv6-7b's K3 at 16 of 64
        # heads, zamba2-2.7b's K4 at 20 of 80 SSD heads and its shared
        # attention's K2 and K1 at 8 of 32 heads of 80 (the decode steps'
        # last length, batch 2 and 1), whisper-small's K2 (encoder over
        # 1500 frames, the 32-token decoder and its cross attention) and
        # K1 (self cache, the 1500-long cross cache) at 3 of 12 heads
        *[c for dt in (f32, bf16) for c in (
            check_wkv6(f"wkv6/mesh-rwkv6-rank/{dt_name(dt)}", 2, 256, 16,
                       64, 64, 64, dt, state=False),
            check_ssd(f"ssd/mesh-zamba2-rank/{dt_name(dt)}", 2, 256, 20, 64,
                      64, 64, dt, True, state=False),
            check_flash(f"flash/mesh-zamba2-rank/{dt_name(dt)}", 2, 256, 256,
                        8, 8, 80, dt, True),
            check_decode(f"decode/mesh-zamba2-rank-b2/{dt_name(dt)}", 2,
                         MAX_SEQ, 8, 8, 80, dt, [8, 8], scalar_len=8),
            check_decode(f"decode/mesh-zamba2-rank-b1/{dt_name(dt)}", 1,
                         ZB1_SMAX, 8, 8, 80, dt, [8], scalar_len=8),
            check_flash(f"flash/mesh-whisper-enc-rank/{dt_name(dt)}", 2,
                        1500, 1500, 3, 3, 64, dt, False),
            check_flash(f"flash/mesh-whisper-dec-rank/{dt_name(dt)}", 2, 32,
                        32, 3, 3, 64, dt, True),
            check_flash(f"flash/mesh-whisper-cross-rank/{dt_name(dt)}", 2,
                        32, 1500, 3, 3, 64, dt, False),
            check_decode(f"decode/mesh-whisper-self-rank/{dt_name(dt)}", 2,
                         MAX_SEQ, 3, 3, 64, dt, [8, 8], scalar_len=8),
            check_decode(f"decode/mesh-whisper-cross-rank/{dt_name(dt)}", 2,
                         1500, 3, 3, 64, dt, [1500, 1500], scalar_len=1500),
        )],
        # this PR's mesh paths, at one rank's shapes: smollm-360m on (1, 4)
        # with 15 heads padded to 16 (K2 at 4 heads, each reading its KV
        # head by index, the last rank's fourth a zero head; K1's
        # sequence-sharded decode at all 15/5 heads over a rank's 256
        # positions), and zamba2-2.7b's batch 1 on (2, 2) (K4 at 40 of 80
        # SSD heads, K2 at 16 of 32 heads of 80, K1 with the lse against a
        # data rank's 6 of 12 positions, full and empty)
        *[c for dt in (f32, bf16) for c in (
            check_flash(f"flash/mesh-smollm-rank/{dt_name(dt)}", 2, 256, 256,
                        4, 4, 64, dt, True),
            check_flash(f"flash/mesh-smollm-pad-rank/{dt_name(dt)}", 2, 256,
                        256, 4, 4, 64, dt, True, zero_heads=1),
            check_decode_lse(f"decode-lse/smollm-shard/{dt_name(dt)}", 2, 256,
                             15, 5, 64, dt, [0, 177]),
            check_ssd(f"ssd/mesh-zamba2-2x2-rank/{dt_name(dt)}", 1, 256, 40,
                      64, 64, 64, dt, True, state=False),
            check_flash(f"flash/mesh-zamba2-2x2-rank/{dt_name(dt)}", 1, 256,
                        256, 16, 16, 80, dt, True),
            check_decode_lse(f"decode-lse/zamba2-b1-2x2/{dt_name(dt)}", 1, 6,
                             16, 16, 80, dt, [6]),
            check_decode_lse(f"decode-lse/zamba2-b1-2x2-empty/{dt_name(dt)}",
                             1, 6, 16, 16, 80, dt, [0]),
        )],
        # K3 at rwkv6-7b's forward (64 heads of 64, chunk 64, the 256-token
        # prompt of the model phase, zero initial state) and at the edges
        check_wkv6("wkv6/main/bf16", **MAIN["wkv6"], state=False,
                   timed=True),
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
        # the WKV6 decode step at rwkv6-7b's captured step (64 slots, 64
        # heads of 64, bf16 products) and in fp32, at a reduced RWKV6's
        # (B=8, 16 heads of 32), at one rank's 16 heads on (1, 4); rows at
        # length 0 among running ones (their stale state must not leak),
        # one scalar length, every head size class up to 128 (dv a
        # multiple of 4 that is no power of 2 among them); eager against
        # graph replay
        check_wkv6_decode("wkv6-decode/main/bf16", **MAIN["wkv6_decode"],
                          timed=True),
        check_wkv6_decode("wkv6-decode/main/fp32", 64, 64, 64, 64, f32,
                          timed=True),
        check_wkv6_decode("wkv6-decode/B8-H16-d32/fp32", 8, 16, 32, 32, f32),
        check_wkv6_decode("wkv6-decode/B8-H16-d32/bf16", 8, 16, 32, 32, bf16),
        check_wkv6_decode("wkv6-decode/mesh-rwkv6-rank/bf16", 64, 16, 64, 64,
                          bf16, timed=True),
        check_wkv6_decode("wkv6-decode/mesh-rwkv6-rank/fp32", 64, 16, 64, 64,
                          f32),
        check_wkv6_decode("wkv6-decode/len0-mixed/bf16", 64, 64, 64, 64, bf16,
                          lens=[0, 1, 0, 700] * 16),
        check_wkv6_decode("wkv6-decode/len0-mixed/fp32", 8, 16, 32, 32, f32,
                          lens=[0, 3, 5, 0, 0, 1, 2, 0]),
        check_wkv6_decode("wkv6-decode/all-len0/bf16", 4, 8, 64, 64, bf16,
                          lens=[0, 0, 0, 0]),
        check_wkv6_decode("wkv6-decode/scalar-len/bf16", 4, 8, 64, 64, bf16,
                          scalar_len=17),
        check_wkv6_decode("wkv6-decode/scalar-len0/fp32", 4, 8, 64, 64, f32,
                          scalar_len=0),
        check_wkv6_decode("wkv6-decode/d16-dv24/fp32", 3, 5, 16, 24, f32,
                          lens=[0, 4, 9]),
        check_wkv6_decode("wkv6-decode/d4/fp32", 2, 3, 4, 4, f32),
        check_wkv6_decode("wkv6-decode/d100/bf16", 3, 7, 100, 100, bf16,
                          lens=[2, 0, 1]),
        check_wkv6_decode("wkv6-decode/d128/fp32", 4, 32, 128, 128, f32,
                          lens=[1, 0, 2, 3]),
        check_wkv6_decode("wkv6-decode/d128/bf16", 64, 32, 128, 128, bf16),
        check_wkv6_decode_graph("wkv6-decode/graph-replay/bf16", 64, 64, 64,
                                64, bf16),
        # the decode step's fused passes at smollm-360m's captured step (64
        # slots) in bf16 and fp32; the norm without a residual (a first
        # layer) and at qwen2-vl-72b's 8192 (four vectors a thread); the
        # rotation and KV write at a group of 7 and head dim 128 (arctic),
        # M-RoPE's tables (qwen2-vl), with rows at length 0 and at the
        # cache's end; silu(g) * u at arctic's dense width
        check_add_rms_norm("norm/main/bf16", **MAIN["add_rms_norm"],
                           timed=True),
        check_add_rms_norm("norm/smollm/fp32", 64, 960, f32),
        check_add_rms_norm("norm/first-layer/bf16", 64, 960, bf16,
                           delta=False),
        check_add_rms_norm("norm/d8192/bf16", 8, 8192, bf16),
        check_add_rms_norm("norm/d8192/fp32", 8, 8192, f32),
        check_rope_kv_write("rope/main/bf16", **MAIN["rope_kv_write"],
                            timed=True),
        check_rope_kv_write("rope/smollm/fp32", 64, 1024, 15, 5, 64, f32),
        check_rope_kv_write("rope/g7-d128/bf16", 8, 300, 56, 8, 128, bf16,
                            lens=[0, 0, 299, 17, 1, 250, 0, 3]),
        check_rope_kv_write("rope/g7-d128/fp32", 8, 300, 56, 8, 128, f32,
                            lens=[0, 5, 299, 17, 1, 250, 0, 3]),
        check_rope_kv_write("rope/mrope-d128/bf16", 4, 64, 64, 8, 128, bf16,
                            lens=[0, 63, 31, 7], mrope=(16, 24, 24)),
        check_silu_mul("silu/main/bf16", **MAIN["silu_mul"], timed=True),
        check_silu_mul("silu/smollm/fp32", 64, 2560, f32),
        check_silu_mul("silu/d4864/bf16", 8, 4864, bf16),
        # K4 at zamba2-2.7b's forward (80 heads, P = N = 64, chunk 64, fp32
        # as the model passes them, B/C broadcast over heads) and the edges
        check_ssd("ssd/main/fp32", **MAIN["ssd"], state=False, timed=True),
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
        # the grouped GEMM (lax.ragged_dot) at the MoE decode steps the
        # serve paths capture (8 slots: arctic-480b C = 16 rows over 128
        # experts, gate/up 7168 -> 4864 and down 4864 -> 7168; kimi-k2 C =
        # 64 over 384, 7168 -> 2048 -> 7168), at arctic's 256-token
        # prefill (C = 512), and at the edges: empty groups, every row in
        # one group, rows past the last group, C a multiple of no tile, N a
        # partial column tile; eager against graph replay
        check_grouped("grouped/arctic-decode-gate/bf16",
                      **MAIN["grouped_matmul"], timed=True, graph=True),
        check_grouped("grouped/arctic-decode-down/bf16", 16, 4864, 7168, 128,
                      moe_group_sizes(8, 2, 128, SEED), bf16, timed=True),
        check_grouped("grouped/arctic-decode-gate/fp32", 16, 7168, 4864, 128,
                      moe_group_sizes(8, 2, 128, SEED), f32, timed=True),
        check_grouped("grouped/kimi-decode-gate/bf16", 64, 7168, 2048, 384,
                      moe_group_sizes(8, 8, 384, SEED), bf16, timed=True,
                      graph=True),
        check_grouped("grouped/kimi-decode-down/bf16", 64, 2048, 7168, 384,
                      moe_group_sizes(8, 8, 384, SEED), bf16, timed=True),
        check_grouped("grouped/kimi-decode-gate/fp32", 64, 7168, 2048, 384,
                      moe_group_sizes(8, 8, 384, SEED), f32),
        check_grouped("grouped/arctic-prefill-gate/bf16", 512, 7168, 4864,
                      128, moe_group_sizes(256, 2, 128, SEED), bf16,
                      timed=True),
        # the fused gate/up pass at the three gate shapes above (its two
        # matrices of each), fp32 at arctic's decode
        check_grouped("swiglu/arctic-decode/bf16", **MAIN["grouped_swiglu"],
                      timed=True, graph=True),
        check_grouped("swiglu/kimi-decode/bf16", 64, 7168, 2048, 384,
                      moe_group_sizes(8, 8, 384, SEED), bf16, timed=True,
                      graph=True, fused=True),
        check_grouped("swiglu/arctic-prefill/bf16", 512, 7168, 4864, 128,
                      moe_group_sizes(256, 2, 128, SEED), bf16, timed=True,
                      fused=True),
        check_grouped("swiglu/arctic-decode/fp32", 16, 7168, 4864, 128,
                      moe_group_sizes(8, 2, 128, SEED), f32, timed=True,
                      fused=True),
        # a decode step of arctic at the usual count of active experts
        # (16 draws over 128 give ~15; SEED's draw gives 13): 15 x 38
        # column tiles fill 264 blocks' rounds badly, so K is split
        check_grouped("swiglu/arctic-decode-15/bf16", 16, 7168, 4864, 128,
                      moe_group_sizes(8, 2, 128, SEED + 1), bf16, timed=True,
                      graph=True, fused=True),
        check_grouped("grouped/arctic-decode-down-15/bf16", 16, 4864, 7168,
                      128, moe_group_sizes(8, 2, 128, SEED + 1), bf16,
                      timed=True, graph=True),
        # the edges of both: empty groups, a group of more rows than one
        # pass holds, rows past the last group, K not a multiple of 8 (x
        # rows not 16-byte aligned) or of a slab, N a partial column tile
        *[c for dt in (f32, bf16) for fused in (False, True) for c in (
            check_grouped(f"{'swiglu' if fused else 'grouped'}/empty-groups/"
                          f"{dt_name(dt)}", 37, 100, 40, 6,
                          [0, 5, 0, 20, 0, 0], dt, fused=fused),
            check_grouped(f"{'swiglu' if fused else 'grouped'}/one-group/"
                          f"{dt_name(dt)}", 37, 100, 40, 5, [0, 0, 37, 0, 0],
                          dt, fused=fused),
            check_grouped(f"{'swiglu' if fused else 'grouped'}/rows-past-last/"
                          f"{dt_name(dt)}", 45, 129, 264, 4, [3, 0, 9, 1], dt,
                          graph=True, fused=fused),
            check_grouped(f"{'swiglu' if fused else 'grouped'}/all-empty/"
                          f"{dt_name(dt)}", 9, 64, 16, 3, [0, 0, 0], dt,
                          fused=fused),
            check_grouped(f"{'swiglu' if fused else 'grouped'}/big-group/"
                          f"{dt_name(dt)}", 300, 136, 392, 7,
                          [40, 0, 170, 1, 0, 77, 3], dt, graph=True,
                          fused=fused),
        )],
    ]
    emit("kernels", cases=cases)
    emit("designs", steps=[time_designs("ssd", SSD_DESIGNS),
                           time_designs("wkv6", WKV6_DESIGNS)])
    by_case = {c["case"]: c for c in cases}
    return {"decode_attention": by_case["decode/main/bf16"],
            "flash_attention": by_case["flash/main/bf16"],
            "wkv6": by_case["wkv6/main/bf16"],
            "ssd": by_case["ssd/main/fp32"],
            "grouped_matmul": by_case["grouped/arctic-decode-gate/bf16"],
            "grouped_swiglu": by_case["swiglu/arctic-decode/bf16"],
            "wkv6_decode": by_case["wkv6-decode/main/bf16"],
            "add_rms_norm": by_case["norm/main/bf16"],
            "rope_kv_write": by_case["rope/main/bf16"],
            "silu_mul": by_case["silu/main/bf16"]}


# -- phase: model ---------------------------------------------------------------

def prefill_vs_decode(cfg, run_kernel, run_plain, prompt_len, tol, label,
                      init_kw, full_depth):
    """forward (on the kernels: flash attention, WKV6 or SSD) vs the same
    prompt fed token by token through decode_step (flash-decode where the
    model attends) vs the same weights on the plain versions; last-position
    logits. A DecoderLM decodes with a (1,) length, as a batcher's step
    does, so its decode takes the fused route (``_use_fused_decode``: the
    three fused passes, or their plain forms in the twin). The plain twin
    is built on 'meta' and takes the kernel model's tensors themselves (``assign=True``): at arctic-480b's width two copies
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
        per_row = cfg.family in ("dense", "moe", "vlm")
        lens = [torch.tensor([t], device="cuda") if per_row else t
                for t in range(prompt_len)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(prompt_len):
            dec, cache = model.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "cache_len": lens[t]})
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        for t in range(prompt_len):
            dec_plain, cache_p = plain.decode_step(
                cache_p, {"tokens": toks[:, t:t + 1], "cache_len": lens[t]})
        dec, dec_plain = dec.float(), dec_plain.float()
    rec = {
        "leg": label, "n_layers": cfg.n_layers, "full_depth": full_depth,
        "dtype": cfg.dtype, "prompt_len": prompt_len, "tol": tol,
        "decode_lengths": "per row" if per_row else "scalar",
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
    ``fp32_depth`` layers (no fp32 leg when None), bf16 at ``bf16_depth``
    (full depth when None).
    ``run_kw`` goes into both RunConfigs (the recurrences' ``seq_chunk``),
    ``init_kw`` into ``init_params``."""
    from dataclasses import replace

    from repro_torch.models.api import RunConfig

    init_kw = init_kw or {}
    run_kernel = RunConfig(attn_impl="kernel", **run_kw)
    run_plain = RunConfig(attn_impl="plain", **run_kw)
    bf16_depth = bf16_depth or cfg.n_layers
    legs = []
    if fp32_depth is not None:
        legs.append(prefill_vs_decode(
            replace(cfg, n_layers=fp32_depth, dtype="float32"), run_kernel,
            run_plain, prompt_len=256, tol=FP32_TOL,
            label=f"fp32-depth{fp32_depth}", init_kw=init_kw,
            full_depth=cfg.n_layers))
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


def captured_vs_eager(exe, tokens, lens) -> dict:
    """One more step of the executable ``exe`` (a graph replay) against
    ``decode_step`` run eagerly on a copy of the same cache with the same
    inputs: the logits and the caches after, compared bit for bit."""
    from repro_torch.models import layers as L

    with torch.inference_mode():
        copy = {k: v.clone() for k, v in exe.cache.items()}
        got = exe(tokens, lens).clone()
        with L.lengths_checked():
            want, copy = exe.model.decode_step(copy, {
                "tokens": exe.tokens.clone(),
                "cache_len": exe.cache_len.clone()})
        torch.cuda.synchronize()
        rec = {"logits_bit_equal": bool(torch.equal(got, want)),
               "caches_bit_equal": all(torch.equal(copy[k], exe.cache[k])
                                       for k in copy),
               "max_abs_err": max_abs_err(got, want)}
    require(bool(torch.isfinite(got.float()).all()),
            "captured logits not finite")
    # the same kernels on the same inputs: a replay is bit-equal to the
    # eager step (every path so far), so any difference is a fault
    require(rec["logits_bit_equal"] and rec["caches_bit_equal"],
            f"captured and eager steps differ: {rec}")
    del copy
    return rec


@contextlib.contextmanager
def unfused_route():
    """DecoderLM's decode step on the unfused route inside the block."""
    from repro_torch.models.transformer import DecoderLM

    real = DecoderLM._use_fused_decode
    DecoderLM._use_fused_decode = lambda self, cache_len: False
    try:
        yield
    finally:
        DecoderLM._use_fused_decode = real


def captured_graph(fn) -> dict:
    """A CUDA graph that captures ``fn()`` once: its nodes
    (``cuGraphGetNodes``) and the device ms of one replay; the
    launches the wrappers counted during the capture are taken back (a
    capture is not a run). None where this torch cannot keep a captured
    graph (then not measured)."""
    import ctypes

    from repro_torch.kernels import ops

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return {"nodes": None, "replay_ms": None}
    before = ops.launch_counts()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        ops.add_launches(ops.launch_delta(before), times=-1)
    n = ctypes.c_size_t(0)
    code = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    require(code == 0, f"cuGraphGetNodes returned {code}")
    graph.instantiate()
    out = {"nodes": n.value, "replay_ms": time_ms(graph.replay, reps=20)}
    del graph
    return out


def fused_counts(cfg) -> dict:
    """What a captured DecoderLM step on the fused route launches of K1
    and the fused passes: a norm before each layer's attention and MLP and
    the final one, one rotation and KV write a layer, silu(g) * u in a
    dense SwiGLU MLP."""
    n = cfg.n_layers
    out = {"decode_attention": n, "add_rms_norm": 2 * n + 1,
           "rope_kv_write": n}
    if cfg.moe is None and cfg.mlp == "swiglu":
        out["silu_mul"] = n
    return out


def fused_vs_unfused(exe, tokens, lens) -> dict:
    """One captured step of ``exe`` (the fused route) against
    ``decode_step`` on the unfused route, run eagerly on a copy of the same
    cache with the same inputs: logits and caches within the model-level
    tolerance of the dtype (the fused kernels round where the plain passes
    round, but the norm sums in another order), and the argmax. Then one
    decode step captured on each route: its graph's nodes and the device
    ms of a replay."""
    from repro_torch.models import layers as L

    model = exe.model
    tol = BF16_TOL if model.cfg.dtype == "bfloat16" else FP32_TOL
    with torch.inference_mode():
        copy = {k: v.clone() for k, v in exe.cache.items()}
        got = exe(tokens, lens).clone()
        inputs = {"tokens": exe.tokens.clone(),
                  "cache_len": exe.cache_len.clone()}
        with L.lengths_checked(), unfused_route():
            want, copy = model.decode_step(copy, inputs)
        torch.cuda.synchronize()
        rec = {"logits_max_abs_err": max_abs_err(got, want),
               "cache_max_abs_err": max(max_abs_err(copy[k], exe.cache[k])
                                        for k in copy),
               "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
               "tol": tol}

        def step():
            with L.lengths_checked():
                model.decode_step(copy, inputs)

        rec["graph"] = captured_graph(step)
        with unfused_route():
            rec["graph_unfused"] = captured_graph(step)
        del copy
    require(rec["logits_max_abs_err"] <= tol
            and rec["cache_max_abs_err"] <= tol,
            f"the fused and unfused steps differ beyond {tol}: {rec}")
    return rec


def moe_launches(exe, tokens, lens, reps: int = 5) -> Optional[list]:
    """Each grouped launch of one captured MoE step, in order: its device
    ms (the mean over ``reps`` replays of the same step under
    ``torch.profiler``: the same tokens at the same lengths rewrite the same
    cache rows, so every replay routes alike), the active experts it read
    (from ``decode_step`` run eagerly on a copy of the cache with the same
    inputs and the wrappers spied) and its share of the byte bound of those
    experts' weights. None when the profiler saw no grouped kernel (then
    not measured)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    calls = []

    def spied(name, fn):
        def call(x, *rest):
            w, gs = rest[0], rest[-1]
            calls.append({"kernel": name, "C": x.shape[0], "K": w.shape[1],
                          "N": w.shape[2], "E": w.shape[0],
                          "matrices": len(rest) - 1,
                          "active_experts": int((gs > 0).sum()),
                          "rows": int(gs.sum())})
            return fn(x, *rest)
        return call

    real = ops._swiglu_kernel, ops._grouped_kernel
    ops._swiglu_kernel = spied("grouped_swiglu", real[0])
    ops._grouped_kernel = spied("grouped_matmul", real[1])
    try:
        with torch.inference_mode(), L.lengths_checked():
            copy = {k: v.clone() for k, v in exe.cache.items()}
            exe.model.decode_step(copy, {
                "tokens": torch.as_tensor(tokens, device="cuda"),
                "cache_len": torch.as_tensor(lens, device="cuda")})
            del copy
    finally:
        ops._swiglu_kernel, ops._grouped_kernel = real
    exe(tokens, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            exe(tokens, lens)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "grouped_" in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) != reps * len(calls):
        return None
    out = []
    for i, c in enumerate(calls):
        ms = sum(evs[i + j * len(calls)].time_range.elapsed_us()
                 for j in range(reps)) / reps / 1e3
        nbytes = (c["matrices"] * c["active_experts"] * c["K"] * c["N"]
                  + c["C"] * c["K"] + c["C"] * c["N"]) * 2 + c["E"] * 8
        b = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({**c, "device_ms": ms, "bound_ms": b,
                    "share_of_bound": b / ms if ms else None})
    return out


def profile_decode_steps(cfg, cache, prompts, n_steps: int = 8) -> dict:
    """Steady state of one replica with every slot busy: wall time per
    lockstep decode step (each a replay of the replica's captured graph),
    the host's waits for the device per step, and from ``torch.profiler``
    the share of that wall time during which the device ran a kernel, with
    the kernels that took most of it. Device numbers are None when the
    profiler saw no device activity (they are then not measured, not
    zero). Beside it the eager step: ``decode_step`` called directly on a
    copy of the cache with the last step's inputs, and the argmax read, as
    the batcher stepped before the capture; and one captured step against
    the eager one on the same cache (``captured_vs_eager``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ContinuousBatcher, Replica

    rep = Replica(cfg, rng_seed=0, max_seq=MAX_SEQ, exec_cache=cache)
    cb = ContinuousBatcher(rep, max_slots=MAX_SLOTS)
    exe = rep.executable(MAX_SLOTS)
    require(exe.graph is not None and cb.cache is exe.cache,
            f"{cfg.name}: the batcher does not step a captured graph")
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

    tok = exe.tokens.cpu().numpy()
    lens = exe.cache_len.cpu().numpy()
    with torch.inference_mode():
        copy = {k: v.clone() for k, v in exe.cache.items()}

        def eager_step():
            logits, _ = rep.model.decode_step(copy, {
                "tokens": torch.from_numpy(tok),
                "cache_len": torch.from_numpy(lens)})
            torch.argmax(logits, dim=-1).cpu()

        eager_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eager_step()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / n_steps * 1e3
        eager_syncs = host_syncs(lambda: [eager_step() for _ in range(2)])
        del copy
    if cfg.family == "ssm":
        require(exe.replay_counts == {"wkv6_decode": cfg.n_layers},
                f"{cfg.name}: a replay launches {exe.replay_counts}, not "
                f"wkv6_decode once a layer ({cfg.n_layers})")
    else:
        want = fused_counts(cfg)
        require({k: exe.replay_counts.get(k) for k in want} == want,
                f"{cfg.name}: a replay launches {exe.replay_counts}, not "
                f"the fused route's {want}")
    check = captured_vs_eager(exe, tok, lens + 1)
    moe = moe_launches(exe, tok, lens + 2) if cfg.family == "moe" else None
    fused = None if cfg.family == "ssm" \
        else fused_vs_unfused(exe, tok, lens + 3)
    out = {"slots_busy": MAX_SLOTS, "steps": n_steps,
           "ms_per_step": step_ms, "ms_per_step_traced": traced_ms,
           "tokens_per_s": MAX_SLOTS / step_ms * 1e3,
           "host_syncs_per_step": None if syncs is None else syncs / 2,
           "eager_ms_per_step": eager_ms,
           "eager_host_syncs_per_step":
               None if eager_syncs is None else eager_syncs / 2,
           "capture_s": exe.capture_s,
           "launches_per_replay": exe.replay_counts,
           "captured_vs_eager": check,
           "fused_vs_unfused": fused,
           "moe_launches": moe,
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
    model that leaked a slot's state into its next request fails it (its
    solo twin is then alone in a batcher of the same slots, not a batch of
    one).
    ``max_scale`` caps the function's sandboxes (one replica at a time
    when a replica needs most of the card). Returns the line it prints."""
    from repro_torch.kernels import ops
    from repro_torch.live import LiveFunctionSpec
    from repro_torch.serving.engine import ContinuousBatcher, Replica
    from repro_torch.serving.exec_cache import ExecutableCache

    class CountingBackend(recording_backend()):
        """Also remembers which slot took which request and how many decode
        steps every sandbox's batcher took, teardowns included."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.admitted = {}
            self.slots_used = set()
            self.retired_steps = 0
            self.captured = []

        def create_hook(self, sandbox):
            super().create_hook(sandbox)
            rt = self.sandboxes[sandbox.sandbox_id]
            exe = rt.replica.executable(MAX_SLOTS)
            self.captured.append(exe.graph is not None
                                 and rt.batcher.cache is exe.cache)

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
    warm_steps_before = cache.warm_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    invs = invoke_all(env, cluster, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    check_served(cfg, invs, lb)
    require(lb.batched_invokes > 0, "no invocation shared a decode step")
    steps = lb.decode_steps()
    warmed = cache.compiled_executables() - warmed_before
    warm_steps = cache.warm_steps - warm_steps_before
    moved = {k: v - before[k] for k, v in ops.launch_counts().items()}
    require(lb.captured and all(lb.captured),
            f"a replica does not decode through a captured graph: "
            f"{lb.captured}")
    # every batcher step is a replay, which adds what its capture counted;
    # the eager warm-up steps before each capture count as they run
    if cfg.family == "ssm":
        # the recurrent decode step's one kernel a layer: the WKV6 step
        others = {k: n for k, n in moved.items() if k != "wkv6_decode" and n}
        require(moved["wkv6_decode"] == (steps + warm_steps) * cfg.n_layers
                and not others,
                f"wkv6_decode launches {moved['wkv6_decode']} != (replays "
                f"{steps} + warm-up steps {warm_steps}) x layers "
                f"{cfg.n_layers}, or other kernels launched: {others}")
    else:
        require(moved["decode_attention"]
                == (steps + warm_steps) * cfg.n_layers,
                f"decode kernel launches {moved['decode_attention']} != "
                f"(replays {steps} + warm-up steps {warm_steps}) x layers "
                f"{cfg.n_layers}")
    if cfg.family == "moe":
        # a layer: the fused gate/up pass, then the down projection
        for k in ("grouped_swiglu", "grouped_matmul"):
            require(moved[k] == (steps + warm_steps) * cfg.n_layers,
                    f"{k} launches {moved[k]} != (replays {steps} + warm-up "
                    f"steps {warm_steps}) x layers {cfg.n_layers}")
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
    # weights, alone in a batch, must give the same greedy tokens. The
    # reused-slot probe (which ran alone in its sandbox's batch of
    # MAX_SLOTS) runs alone in a batcher of MAX_SLOTS slots: at one row
    # cuBLAS takes other paths than at eight, and rwkv6-7b's bf16 logits
    # then part by up to ~0.3 on either WKV6 decode form (measured on one
    # H100), enough to flip a near-tie of greedy tokens; at one shape no
    # row's arithmetic depends on another's, so any difference is state
    # that the slot's earlier requests left behind
    solo_rep = Replica(cfg, rng_seed=where["sandbox"], max_seq=MAX_SEQ,
                       run_cfg=spec.run_cfg, exec_cache=cache)
    if reused_probe:
        twin = ContinuousBatcher(solo_rep, max_slots=MAX_SLOTS)
        rid = twin.add_request(probe_prompt, max_new=MAX_NEW)
        while rid not in twin.finished:
            twin.step()
        solo = twin.finished[rid]
        del twin
    else:
        solo = solo_rep.generate(probe_prompt, max_new_tokens=MAX_NEW)
    del solo_rep
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
        warmed_signatures=warmed, warm_steps=warm_steps,
        captured_replicas=len(lb.captured),
        ms_per_decode_step=invoke_s / max(steps, 1) * 1e3,
        batched_invokes=lb.batched_invokes, kernel_launches=moved,
        teardowns=lb.teardowns, exec_cache=stats,
        admitted_after_steps=reuse_count,
        probe={"reused": reused_probe, **where, "tokens_equal_solo": True},
        steady_state=profile, peak_memory_bytes=peak)
    emit("serve", **rec)
    return rec


def phase_cache_owners(cfg) -> None:
    """Each user of ``Replica.new_cache`` decodes on a cache of its own
    (ROADMAP C12): a batcher's requests run alone on a replica, then again
    on the same replica with interference after 4 steps: a ``generate``
    (batch 1) and a second batcher of the same batch size that serves a
    request of its own. The first batcher's tokens must equal its solo run.
    The later caches are fresh executables, captured when they are asked
    for; their capture seconds are recorded."""
    from repro_torch.serving.engine import ContinuousBatcher, Replica
    from repro_torch.serving.exec_cache import ExecutableCache

    prompts = serve_prompts(cfg)[:MAX_SLOTS]
    cache = ExecutableCache()
    rep = Replica(cfg, rng_seed=0, max_seq=MAX_SEQ, exec_cache=cache)

    def batch_run(interfere):
        cb = ContinuousBatcher(rep, max_slots=MAX_SLOTS)
        rids = [cb.add_request(p, max_new=MAX_NEW) for p in prompts]
        for _ in range(4):
            cb.step()
        if interfere:
            interfere()
        cb.run_until_done()
        return cb, [cb.finished[r] for r in rids]

    solo_cb, solo = batch_run(None)
    others = {}

    def interfere():
        t0 = time.perf_counter()
        others["generate"] = rep.generate([9, 9], 2)
        others["generate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = ContinuousBatcher(rep, max_slots=MAX_SLOTS)
        others["second_new_cache_s"] = time.perf_counter() - t0
        second.add_request(prompts[-1], max_new=8)
        second.run_until_done()
        others["second"] = second

    cb, got = batch_run(interfere)
    exes = rep._executables[MAX_SLOTS]
    second = others["second"]
    require(got == solo,
            f"a batcher's tokens changed when generate and a second batcher "
            f"ran beside it: {sum(a == b for a, b in zip(got, solo))} of "
            f"{len(solo)} requests equal")
    require(len({id(solo_cb.cache), id(cb.cache), id(second.cache)}) == 3
            and all(e.graph is not None for e in exes),
            "the batchers do not decode on three captured caches")
    emit("cache_owners", config=cfg.name, max_slots=MAX_SLOTS,
         requests=len(prompts), tokens_equal_solo=True,
         executables_of_batch=len(exes),
         capture_s=[e.capture_s for e in exes],
         second_new_cache_s=others["second_new_cache_s"],
         generate_s=others["generate_s"],
         compiled_executables=cache.compiled_executables(),
         captured_graphs=cache.captured_graphs())
    del rep, cb, solo_cb, second, exes, others
    torch.cuda.empty_cache()


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

    import numpy as np

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
    steps = warm_steps = 0
    check = None
    for sid, reqs in sorted(by_sandbox.items()):
        cache = ExecutableCache()
        rep = Replica(cfg, rng_seed=sid, max_seq=MAX_SEQ, exec_cache=cache)
        cb = ContinuousBatcher(rep, max_slots=MAX_SLOTS)
        require(rep.executable(MAX_SLOTS).graph is not None,
                "the in-process replica's step is not a captured graph")
        for w in range(0, len(reqs), MAX_SLOTS):
            wave = reqs[w:w + MAX_SLOTS]
            rids = [cb.add_request(p, max_new=MAX_NEW) for p, _ in wave]
            cb.run_until_done()
            for rid, (_, toks) in zip(rids, wave):
                require(cb.finished[rid] == toks,
                        f"sandbox {sid}: container tokens {toks} != "
                        f"in-process {cb.finished[rid]}")
        steps += cb.steps
        warm_steps += cache.warm_steps
        del rep, cb
    moved = {k: v - before[k] for k, v in ops.launch_counts().items()}
    require(moved["decode_attention"] == (steps + warm_steps) * cfg.n_layers,
            f"in-process decode kernel launches {moved['decode_attention']} "
            f"!= (replays {steps} + warm-up steps {warm_steps}) x layers "
            f"{cfg.n_layers}")
    # one more captured step of an in-process replica against the eager one
    rep = Replica(cfg, rng_seed=0, max_seq=MAX_SEQ,
                  exec_cache=ExecutableCache())
    exe = rep.executable(MAX_SLOTS)
    tok = np.arange(1, MAX_SLOTS + 1, dtype=np.int32)[:, None]
    for t in range(4):
        exe(tok + t, np.full(MAX_SLOTS, t, np.int32))
    check = captured_vs_eager(exe, tok, np.full(MAX_SLOTS, 4, np.int32))
    del rep, exe
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
         in_process_warm_steps=warm_steps,
         in_process_kernel_launches=moved, captured_vs_eager=check,
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
    steps = len(prompt) + MAX_NEW
    for _ in range(2):
        rep = Replica(cfg, rng_seed=SEED, max_seq=MAX_SEQ,
                      exec_cache=ExecutableCache())
        exe = rep.executable(1)
        require(exe.graph is not None,
                "generate's step is not a captured graph")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = rep.generate(prompt, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0))
        require(exe.replays == steps,
                f"generate replayed {exe.replays} of {steps} steps")
        check = captured_vs_eager(exe, [[toks[-1]]], steps)
        capture_s = exe.capture_s
        del rep, exe
        torch.cuda.empty_cache()
    (a, sa), (b, sb) = runs
    require(len(a) == MAX_NEW and all(0 <= t < cfg.vocab for t in a),
            f"generate: tokens {a}")
    require(a == b, f"generate differs between two runs on the same "
            f"weights: {a} vs {b}")
    emit("generate", config=cfg.name, prompt_len=len(prompt),
         max_new_tokens=MAX_NEW, tokens=a, seconds=[sa, sb],
         ms_per_step=[sa / steps * 1e3, sb / steps * 1e3],
         capture_s=capture_s, captured_vs_eager=check)


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
        "grouped_matmul": lambda q: ops.grouped_matmul(
            q.reshape(64, 128), t(2, 128, 64),
            torch.tensor([30, 34], device="cuda")),
        "grouped_swiglu": lambda q: ops.grouped_swiglu(
            q.reshape(64, 128), t(2, 128, 64), t(2, 128, 64),
            torch.tensor([30, 34], device="cuda")),
        "wkv6_decode": lambda q: ops.wkv6_decode(
            q[:, :1].contiguous(), t(1, 1, 2, 64), t(1, 1, 2, 64),
            torch.rand((1, 1, 2, 64), device="cuda"), t(2, 64),
            t(1, 2, 64, 64), 1),
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
                     device="cuda", compiled=False)
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


def profile_train_step(step) -> dict:
    """One more train step, ``step()`` (its batch made before), under
    ``torch.profiler``: wall time, the device's busy time and share, its
    kernel launches, and the kernels that took most of it (device numbers
    None when the profiler saw no device activity: not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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


REMAT_OFF_STEPS = 3     # eager steps of the remat-off leg
TIMED_REPLAYS = 3       # replays timed alone between two events
LAUNCHER_STEPS = 10     # captured steps run back to back, as the launcher


def states_equal(a, b) -> dict:
    """Two trainers' states compared bit for bit: the AdamW step, every
    parameter and both moments; where they differ, the largest absolute
    difference."""
    same, diff = int(a.opt.step) == int(b.opt.step), 0.0
    for k, p in a.params.items():
        for x, y in ((p, b.params[k]), (a.opt.mu[k], b.opt.mu[k]),
                     (a.opt.nu[k], b.opt.nu[k])):
            if not torch.equal(x, y):
                same = False
                diff = max(diff, float((x.float() - y.float()).abs().max()))
    return {"equal": same, "max_abs_diff": diff}


def timed_step(tr, i) -> tuple:
    """``tr.step(i)`` between two synchronises: its metrics, its seconds,
    and the bytes it allocated above what was live before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = tr.step(i)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def state_bytes(tr) -> int:
    return sum(p.numel() * p.element_size() for p in tr.params.values()) \
        + tr.moment_bytes()


def remat_off_leg(cfg) -> dict:
    """REMAT_OFF_STEPS eager steps with remat off at the phase's shape,
    alone on the card: the bytes a step allocates above the state, the
    peak, the step time."""
    from dataclasses import replace

    from repro_torch.launch.train import Trainer, run_config

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, replace(run_config(), remat=False), seq=TRAIN_SEQ,
                 batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED, device="cuda",
                 compiled=False)
    rec = {"losses": [], "step_s": [], "step_bytes": []}
    for i in range(REMAT_OFF_STEPS):
        m, dt, nbytes = timed_step(tr, i)
        rec["losses"].append(float(m["loss"]))
        rec["step_s"].append(dt)
        rec["step_bytes"].append(nbytes)
    rec["state_bytes"] = state_bytes(tr)
    rec["peak_bytes"] = rec["state_bytes"] + max(rec["step_bytes"])
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_lm(cfg) -> None:
    """The training launcher's step on the card (``Trainer``: its RunConfig
    with the plain attention forms and remat on, ZipfLMStream, AdamW):
    TRAIN_STEPS steps at full width and depth in bf16 through the default
    ``Trainer``, which the rule captures (``compiled``: two eager warm
    steps, the capture, then replays), against a twin ``Trainer`` stepped
    eagerly (``compiled=False``) on the same seed in lockstep: after every
    step the loss, every parameter, both AdamW moments and the step
    counter bit-equal (a second eager trainer's first step shows whether
    eager itself is: where it is not, the captured run may differ from the
    twin by no more than the two eager ones do, step by step). The loss
    falls and stays finite; a remat-off leg at the same shape allocates
    more a step; one checkpoint saved, restored on the CPU and compared
    bit for bit; the kernels' refusal of gradients probed; grad
    accumulation against one step at fp32 depth 4, and through the
    executable."""
    import shutil
    from dataclasses import replace

    from repro_torch.launch.train import Trainer, run_config
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

    off = remat_off_leg(cfg)
    kw = dict(seq=TRAIN_SEQ, batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
              device="cuda")
    tr = Trainer(cfg, run_config(), **kw)
    require(tr.compiled, f"train: the default Trainer is not compiled: "
                         f"{tr.eager_reason}")
    twin = Trainer(cfg, run_config(), compiled=False, **kw)
    n_params = sum(p.numel() for p in tr.params.values())
    t0 = time.perf_counter()
    tr.stream.batch_at(0)
    data_s = time.perf_counter() - t0
    losses, gnorms, step_s, twin_s, twin_bytes = [], [], [], [], []
    vs_twin, eager_pair = [], []
    third = None
    for i in range(TRAIN_STEPS):
        m, dt, _ = timed_step(tr, i)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(dt)
        mt, dt, nbytes = timed_step(twin, i)
        twin_s.append(dt)
        twin_bytes.append(nbytes)
        cmp = states_equal(tr, twin)
        cmp["loss_equal"] = torch.equal(m["loss"], mt["loss"])
        vs_twin.append(cmp)
        if i == 0:
            third = Trainer(cfg, run_config(), compiled=False, **kw)
        if third is not None:
            third.step(i)
            eager_pair.append(states_equal(twin, third))
            if eager_pair[-1]["equal"]:
                del third       # eager is deterministic: the gate is bits
                third = None
                gc.collect()
    exe = tr.exe
    require(exe.warm_steps == 2 and exe.replays == TRAIN_STEPS - 2
            and exe.graph is not None,
            f"train: {exe.warm_steps} warm steps, {exe.replays} replays")
    bitwise = all(e["equal"] for e in eager_pair)
    for i, c in enumerate(vs_twin):
        if bitwise:
            require(c["equal"] and c["loss_equal"],
                    f"train: step {i + 1} captured vs eager: {c}")
        else:
            require(c["max_abs_diff"] <= eager_pair[i]["max_abs_diff"],
                    f"train: step {i + 1} captured vs eager {c} beyond "
                    f"eager vs eager {eager_pair[i]}")
    steady = sorted(step_s[2:])[len(step_s[2:]) // 2]
    steady_eager = sorted(twin_s[2:])[len(twin_s[2:]) // 2]
    require(all(math.isfinite(x) for x in losses + gnorms),
            f"train: non-finite loss or grad norm: {losses} {gnorms}")
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    on_bytes = max(twin_bytes)
    require(on_bytes < max(off["step_bytes"]),
            f"train: a remat step allocates {on_bytes} bytes, a step "
            f"without remat {max(off['step_bytes'])}")

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
    batch = tr.stream.batch_at(TRAIN_STEPS)
    profile = profile_train_step(lambda: tr.exe(batch))
    require(exe.replays == TRAIN_STEPS - 1, "train: the profiled step was "
                                            "not a replay")

    def eager_step():
        twin.opt, _ = twin.step_fn(twin.opt, batch, None)

    profile_eager = profile_train_step(eager_step)
    after = states_equal(tr, twin)
    require(after["equal"] or not bitwise,
            f"train: the profiled steps differ: {after}")
    graph_pool = torch.cuda.memory_reserved()
    capture_s, warm_steps, replays = exe.capture_s, exe.warm_steps, \
        exe.replays
    # ``timed_step`` puts the batch's host generation in series with the
    # step. The replay alone, between two events, its batch made before;
    # then the launcher's loop (``launch/train.py``): steps back to back,
    # each loss kept on the device, so the host makes a batch while the
    # previous replay runs
    replay_ms = []
    for i in range(TIMED_REPLAYS):
        batch = tr.stream.batch_at(TRAIN_STEPS + 1 + i)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        exe(batch)
        end.record()
        end.synchronize()
        replay_ms.append(start.elapsed_time(end))
    first = TRAIN_STEPS + 1 + TIMED_REPLAYS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = [tr.step(i)["loss"]
               for i in range(first, first + LAUNCHER_STEPS)]
    launcher_losses = torch.stack(pending).tolist()
    launcher_ms = (time.perf_counter() - t0) / LAUNCHER_STEPS * 1e3
    require(all(math.isfinite(x) for x in launcher_losses),
            f"train: non-finite loss in the launcher's loop: "
            f"{launcher_losses}")
    replay_steady = sorted(replay_ms)[len(replay_ms) // 2]
    STEP_TIMES["train/smollm-360m"] = replay_steady
    del tr, twin, third, restored, exe, eager_step
    gc.collect()
    torch.cuda.empty_cache()

    refused = probe_grad_refusal()
    small = replace(cfg, n_layers=4, dtype="float32")
    accum = accum_equivalence(small)
    accum["executable"] = accum_executable(small)
    emit("train", config=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
         params=n_params, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, lr=TRAIN_LR, run=str(run_config()), compiled=True,
         losses=losses, grad_norms=gnorms, step_seconds=step_s,
         steady_ms_per_step=steady * 1e3,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady, replay_ms=replay_ms,
         launcher_ms_per_step=launcher_ms,
         launcher_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / launcher_ms * 1e3,
         eager_step_seconds=twin_s, eager_steady_ms_per_step=steady_eager
         * 1e3, capture_s=capture_s, warm_steps=warm_steps,
         replays=replays, vs_eager_twin=vs_twin,
         eager_vs_eager=eager_pair, gate="bit-equal" if bitwise else
         "captured-vs-eager <= eager-vs-eager",
         data_seconds_per_batch=data_s,
         memory={"state_bytes": off["state_bytes"],
                 "remat_on_step_bytes": on_bytes,
                 "remat_on_peak_bytes": off["state_bytes"] + on_bytes,
                 "remat_off_step_bytes": max(off["step_bytes"]),
                 "remat_off_peak_bytes": off["peak_bytes"],
                 "reserved_with_graph_bytes": graph_pool},
         remat_off={"steps": REMAT_OFF_STEPS, "losses": off["losses"],
                    "step_seconds": off["step_s"],
                    "losses_equal_remat_on": off["losses"] == losses[
                        :REMAT_OFF_STEPS]},
         checkpoint={"bytes": ckpt_bytes, "async_returned_s": handed_back_s,
                     "save_s": save_s, "restore_cpu_s": restore_s,
                     "params_bit_equal": True, "moments_bit_equal": True},
         refused_grad=refused, grad_accum=accum, profile_replay=profile,
         profile_eager=profile_eager)


def accum_executable(cfg) -> dict:
    """grad_accum 2 through the executable: a captured ``Trainer`` against
    an eager one on the same per-layer fan-in weights, three steps (two
    warm, one replay), bit-equal after each."""
    from repro_torch.launch.train import Trainer, run_config

    pair = []
    for compiled in (True, False):
        tr = Trainer(cfg, run_config(grad_accum=2), seq=TRAIN_SEQ,
                     batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED,
                     device="cuda", compiled=compiled)
        tr.model.init_params(
            torch.Generator(device="cuda").manual_seed(SEED),
            layer_fan_in=True)
        pair.append(tr)
    mine, eager = pair
    steps = []
    for i in range(3):
        a, b = mine.step(i), eager.step(i)
        c = states_equal(mine, eager)
        c["loss_equal"] = torch.equal(a["loss"], b["loss"])
        steps.append(c)
    rec = {"steps": steps, "replays": mine.exe.replays}
    require(mine.exe.replays == 1, f"accum: {rec}")
    require(all(c["equal"] and c["loss_equal"] for c in steps),
            f"accum: the executable differs from eager: {rec}")
    del pair, mine, eager
    gc.collect()
    torch.cuda.empty_cache()
    return rec


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
    # an eager step, as before the captured train step: make_train_step
    # itself, compiled=False in Trainer's terms
    emit("train-whisper", config=cfg.name, dtype=cfg.dtype, compiled=False,
         remat=model.run.remat, batch=b,
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
    the reduced model) at 400 requests a virtual second, so that the
    autoscaler starts several sandboxes (the wall time a request takes is
    billed to the simulated clock; a captured step serves one in a few ms,
    so at 40 a second, one every 25 ms, one sandbox kept up with all of
    them): every request ok, and each one's
    tokens equal a solo replica drawn from the seed of the sandbox it was
    admitted to (each sandbox's replica has other weights)."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Replica

    out = serve.main(["--device", "cuda", "--rate", "400"])
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


# -- phase: churn-live ----------------------------------------------------------

CHURN_MEMORY_SLACK = 256 << 20    # bytes; one leaked replica is ~0.72 GB


def phase_churn_live(cfg) -> None:
    """The live churn bench's process-mode cold/warm point (one cold
    creation, four warm) and its first grid cell (8 workers, 50 requests a
    virtual second for 2 s, 8 functions) at smollm-360m's full width
    (``benchmarks/torch_churn_live.py``): no failed creation, every request
    done with its 8 tokens, the first and the last of them the tokens a
    solo replica with their sandbox's seed decodes, no leaked replica,
    every replica decoding by replaying its captured graph, the decode
    kernel's launches equal to (replays + eager warm-up steps, the solo
    replicas' included) x layers, and the device memory back where it was
    once the backends are closed."""
    from benchmarks import torch_churn_live as bench
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    before = ops.launch_counts()
    cw = bench.live_cold_warm_point("process")
    cell = bench.live_grid_point(8, 50.0, 2.0)
    moved = ops.launch_delta(before).get("decode_attention", 0)
    cell.pop("_invoke_walls")
    cell.pop("_start_log")
    for where, rec in (("cold/warm", cw), ("grid", cell)):
        problems = bench.failures(rec)     # uncaptured replicas included
        require(not problems and rec["width"] == "full",
                f"churn-live {where}: {problems}, width {rec['width']}")
    require([r["cold"] for r in cw["creates"]] == [True] + [False] * 4,
            f"churn-live: cold/warm rows {cw['creates']}")
    require(cell["done"] == cell["total"] == 100 and cell["cold_creates"] == 1
            and len(cell["solo_checks"]) == 2,
            f"churn-live grid: {cell['done']}/{cell['total']} done, "
            f"{cell['cold_creates']} cold creations, solo checks "
            f"{cell['solo_checks']}")
    steps = cw["decode_steps"] + cell["decode_steps"]
    warm_steps = cw["warm_steps"] + cell["warm_steps"] + cell["solo_steps"]
    require(moved == (steps + warm_steps) * cfg.n_layers,
            f"churn-live: decode kernel launches {moved} != (replays {steps} "
            f"+ warm-up and solo steps {warm_steps}) x layers "
            f"{cfg.n_layers}")
    gc.collect()
    torch.cuda.empty_cache()
    mem_after = torch.cuda.memory_allocated()
    require(mem_after - mem_before <= CHURN_MEMORY_SLACK,
            f"churn-live: {mem_after - mem_before} bytes still allocated "
            f"after close()")
    emit("churn-live", config=cfg.name, n_layers=cfg.n_layers,
         cold_create_ms=cw["cold_create_s"] * 1e3,
         warm_create_ms=cw["warm_create_s"] * 1e3,
         **{k: cw[k] for k in ("cold_build_ms_median",
                               "cold_warmup_ms_median",
                               "cold_capture_ms_median",
                               "warm_build_ms_median",
                               "warm_warmup_ms_median",
                               "warm_capture_ms_median")},
         grid={k: cell[k] for k in (
             "workers", "rate", "duration", "creations", "cold_creates",
             "warm_creates", "cold_create_ms_median", "warm_create_ms_median",
             "cold_build_ms_median", "cold_warmup_ms_median",
             "cold_capture_ms_median", "warm_build_ms_median",
             "warm_warmup_ms_median", "warm_capture_ms_median",
             "creations_per_wall_s", "done", "total", "p50_ms", "p99_ms",
             "invoke_wall_p50_ms", "invoke_wall_p99_ms", "tokens",
             "tokens_per_wall_s", "batched_invokes", "peak_replicas",
             "peak_memory_bytes", "wall_s", "sim_s", "decode_steps",
             "solo_checks", "solo_steps")},
         decode_launches=moved, memory_delta_bytes=mem_after - mem_before,
         device=cell["device"])


# -- mesh paths -----------------------------------------------------------------
#
# Each is MESH_RANKS processes spawned from this script (torch.multiprocessing,
# ``spawn``), all on cuda:0, joined in one gloo group
# (``repro_torch.launch.mesh.run_ranks``): NCCL refuses two ranks on one
# device, and gloo stages the CUDA tensors of every collective through host
# memory. Times here are four processes sharing one H100 over gloo; they
# say nothing about NVLink or NCCL. A rank's failure fails the run. Each
# path's yardstick is the port on one device with the same weights, run in
# this process before the ranks start and freed before they do, so the two
# copies are never on the card together; its launches are comparisons and
# are not counted. A rank writes its results and its launch counters to a
# file; the path's counts are the ranks' sums.

MESH_RANKS = 4
MESH_TIMEOUT = 480          # seconds a spawn of ranks may take
MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")
MESH_B, MESH_S = 2, 256     # prefill batch and length
MESH_START, MESH_STEPS = 240, 32   # decode: cache_len 240 .. 271
MESH_FP32_TOL = 1e-4        # tests/test_moe.py:156, the reference's bound
EP_TOL = 2e-2               # tests/test_moe.py:114, the reference's EP bound


def run_mesh(tag, fn, *args, world=MESH_RANKS) -> tuple:
    """``fn(rank, world, out, *args)`` on ``world`` ranks; returns their
    result files (rank order) and the wall seconds of the spawn."""
    import shutil

    from repro_torch.launch.mesh import run_ranks

    out = os.path.join(MESH_DIR, f"{tag}-{os.getpid()}-{time.time_ns()}")
    os.makedirs(out)
    t0 = time.perf_counter()
    try:
        run_ranks(fn, world, (out,) + args, timeout=MESH_TIMEOUT,
                  rendezvous=os.path.join(out, "rendezvous"))
    except Exception as e:                 # a rank failed: the phase fails
        raise SmokeFailure(f"{tag}: {type(e).__name__}: {e}") from e
    wall = time.perf_counter() - t0
    res = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(world)]
    shutil.rmtree(out)
    return res, wall


def rank_begin():
    """A rank's start: cuda:0, the library phase_build built (with
    ``-Xptxas -v``, so under its own hash: a rank asking for the plain
    build would compile again), the counters at 0. Four processes share
    the card's memory: each allocator maps its blocks in expandable
    segments, so that freed memory is not held in fragments."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    from repro_torch.kernels import build, ops
    build.load(verbose_ptxas=True)
    ops.reset_launch_counts()


def rank_end(out, rank, rec) -> None:
    from repro_torch.kernels import ops
    rec["launches"] = ops.launch_counts()
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def summed_launches(ranks) -> dict:
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


@contextlib.contextmanager
def timed_collectives():
    """The collectives run inside the block, as the port's collective log
    records them (``records``: kind, bytes, group), and the host seconds
    inside them (``seconds``), the device synchronised before each call so
    that the compute it waits for is not counted (this adds syncs: used on
    a pass of its own)."""
    from repro_torch.models import sharding as S

    class Timed(S.CollectiveLog):
        seconds = 0.0

        def run(self, kind, nbytes, group_size, call):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().run(kind, nbytes, group_size, call)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

    with S.log_collectives(Timed()) as log:
        yield log


def collectives_rec(tc, steps, wall) -> dict:
    """A timed pass's line: per step its collectives (each kind's count and
    bytes, the port's log summarised as the dry run summarises it), their
    host milliseconds and share of the step's wall."""
    from repro_torch.launch.collectives import summarize

    per_step = {k: {"count": v["count"] / steps, "bytes": v["bytes"] / steps,
                    "group": v["group"]}
                for k, v in summarize(tc.records).items()}
    return {"steps": steps, "calls_per_step": len(tc.records) / steps,
            "per_step": per_step, "ms_per_step": wall / steps * 1e3,
            "collective_ms_per_step": tc.seconds / steps * 1e3,
            "share": tc.seconds / wall}


def mesh_tokens(cfg):
    g = torch.Generator().manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab, (MESH_B, MESH_S), generator=g,
                           dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab, (MESH_B, MESH_STEPS), generator=g,
                          dtype=torch.int32)
    return prompt.cuda(), steps.cuda()


def seeded_cache(model):
    """K/V of every layer with the first MESH_START positions drawn from
    the seed (the same draw on every rank and on one device), the rest 0;
    on a mesh the rank's part of ``cache_pspecs``."""
    from repro_torch.compat import torch_dtype
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import sharding as S

    cfg = model.cfg
    shape = ShapeSpec("mesh", MAX_SEQ, MESH_B, "decode")
    dims = (cfg.n_layers, MESH_B, MESH_START, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cache = {}
    for kv in "kv":
        t = torch.zeros(dims[:2] + (MAX_SEQ,) + dims[3:],
                        dtype=torch_dtype(cfg.dtype), device="cuda")
        t[:, :, :MESH_START] = torch.randn(dims, generator=g, device="cuda")
        if model.mesh is not None:
            t = S.local_shard(t, model.cache_pspecs(shape)[kv], model.mesh,
                              kv).contiguous()
        cache[kv] = t
    return cache


def drive_lm(model, prompt, steps, timed_pass=False) -> dict:
    """Prefill ``prompt`` (timed twice), then a decode step for each column
    of ``steps`` from the seeded cache at MESH_START; logits to the host.
    With ``timed_pass``, 8 more steps with the collectives timed."""
    rec = {}
    with torch.inference_mode():
        for key in ("prefill_s", "prefill_again_s"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model.forward({"tokens": prompt})
            torch.cuda.synchronize()
            rec[key] = time.perf_counter() - t0
        rec["prefill"] = logits.float().cpu()
        del logits
        cache = seeded_cache(model)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps.shape[1]):
            lg, cache = model.decode_step(cache, {
                "tokens": steps[:, t:t + 1], "cache_len": MESH_START + t})
            outs.append(lg)
        torch.cuda.synchronize()
        rec["decode_ms_per_step"] = (time.perf_counter() - t0) \
            / steps.shape[1] * 1e3
        rec["decode"] = torch.stack(outs).float().cpu()
        if timed_pass:
            cache = seeded_cache(model)
            with timed_collectives() as tc:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(8):
                    model.decode_step(cache, {
                        "tokens": steps[:, t:t + 1],
                        "cache_len": MESH_START + t})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rec["collectives"] = collectives_rec(tc, 8, wall)
    return rec


def lm_compare(label, got, want, tol, gated=True) -> dict:
    """Logits of a mesh leg against its yardstick's (the rows ``got``
    holds: ``rows`` of the batch); greedy agreement beside the error."""
    rows = got.get("rows", slice(None))
    out = {"leg": label, "tol": tol}
    for key in ("prefill", "decode"):
        if key not in got:
            continue
        w = want[key][rows] if key == "prefill" else want[key][:, rows]
        g = got[key]
        require(g.shape == w.shape, f"{label}: {key} shape {tuple(g.shape)}")
        require(bool(torch.isfinite(g).all()), f"{label}: {key} not finite")
        out[f"{key}_max_abs_err"] = max_abs_err(g, w)
        out[f"{key}_greedy_agree"] = float(
            (g.argmax(-1) == w.argmax(-1)).float().mean())
        if gated:
            require(out[f"{key}_max_abs_err"] <= tol,
                    f"{label}: {key} max_abs_err "
                    f"{out[f'{key}_max_abs_err']} > {tol}")
    return out


def yardstick_lm(cfg, run, prompt, steps, init_kw) -> dict:
    from repro_torch.models.api import build_model

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, run, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                      **init_kw)
    rec = drive_lm(model, prompt, steps)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# qwen3-32b's and smollm-360m's legs (smollm's 15 heads padded to 16 on
# the 4 ranks: the last rank's fourth head is a zero head)
LM_LEGS = (("fp32-depth2", "float32", 2, MESH_FP32_TOL),
           ("bf16-depth8", "bfloat16", 8, BF16_TOL))
MESH_LM = ("qwen3-32b", "smollm-360m")
# one-device step times the roofline phase prints beside the dry run's
# counted terms, and every timed leg of a mesh path with the collectives
# its step ran on the card (filled by the phases that measure them)
STEP_TIMES = {}
ROOFLINE_LEGS = []


def mesh_lm_rank(rank, world, out):
    """One rank of mesh/qwen3-32b and mesh/smollm-360m on (data 1, model
    4): every leg's tensor-parallel prefill (K2 at the rank's 16 heads,
    smollm's 4 of 16 padded) and sequence-sharded decode (K1 with the lse
    over the rank's 256 positions, every head), the launch counters zeroed
    before each model and read after it."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig, build_model

    rank_begin()
    mesh = S.make_mesh((1, MESH_RANKS), ("data", "model"), "cuda")
    rec = {}
    for name in MESH_LM:
        ops.reset_launch_counts()
        cfg = get_config(name)
        prompt, steps = mesh_tokens(cfg)
        legs = {}
        for label, dtype, depth, _ in LM_LEGS:
            torch.cuda.reset_peak_memory_stats()
            with S.use_mesh(mesh):
                model = build_model(replace(cfg, n_layers=depth, dtype=dtype),
                                    RunConfig(sharded_decode=True),
                                    device="cuda")
            model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                              layer_fan_in=True)
            res = drive_lm(model, prompt, steps, timed_pass=True)
            res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            if rank:
                res.pop("prefill"), res.pop("decode")
            legs[label] = res
            del model
            gc.collect()
            torch.cuda.empty_cache()
        legs["launches"] = ops.launch_counts()
        rec[name] = legs
    rank_end(out, rank, rec)


_LM_RANKS = {}


def mesh_lm_spawn() -> dict:
    """The yardsticks (one device, each built and freed in turn), then one
    spawn of ranks for both models; cached for the two paths."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import RunConfig

    if not _LM_RANKS:
        want = {}
        for name in MESH_LM:
            cfg = get_config(name)
            prompt, steps = mesh_tokens(cfg)
            for label, dtype, depth, _ in LM_LEGS:
                want[name, label] = yardstick_lm(
                    replace(cfg, n_layers=depth, dtype=dtype), RunConfig(),
                    prompt, steps, {"layer_fan_in": True})
        ops.reset_launch_counts()         # the yardsticks' do not count
        ranks, wall = run_mesh("lm", mesh_lm_rank)
        _LM_RANKS.update(want=want, ranks=ranks, wall=wall)
    return _LM_RANKS


def phase_mesh_lm(cfg) -> dict:
    """mesh/qwen3-32b at full width (d 5120, 64/8 heads of 128, d_ff 25600,
    vocab 151936, qk_norm), the reference's own sharded-decode model
    (tests/test_moe.py:128-162), and mesh/smollm-360m at full width (d 960,
    15/5 heads of 64 padded to 16 query heads, 4 a rank, vocab 49152
    tied): per leg a prefill forward (B=2, S=256) and 32 decode steps with
    ``sharded_decode=True`` over a 1024-long cache (256 positions a rank)
    whose first 240 positions are seeded, so the owner of the written
    position moves from rank 0 to rank 1 at step 17. fp32 (depth 2)
    within 1e-4 of one device, bf16 (depth 8) within 0.5 with greedy
    agreement recorded, on per-layer fan-in weights (ROADMAP §C4)."""
    run = mesh_lm_spawn()
    ranks = [r[cfg.name] for r in run["ranks"]]
    legs = []
    for label, dtype, depth, tol in LM_LEGS:
        got = ranks[0][label]
        want = run["want"][cfg.name, label]
        rec = lm_compare(label, got, want, tol)
        rec.update(
            n_layers=depth, dtype=dtype,
            ranks={k: [r[label][k] for r in ranks] for k in (
                "prefill_s", "prefill_again_s", "decode_ms_per_step",
                "peak_memory_bytes", "collectives")},
            one_device={k: want[k] for k in (
                "prefill_s", "prefill_again_s", "decode_ms_per_step",
                "peak_memory_bytes")})
        legs.append(rec)
        ROOFLINE_LEGS.append(dict(
            path=f"mesh/{cfg.name}", leg=label, cfg=family_cfg(
                cfg.name, dtype, depth), run={"sharded_decode": True},
            mesh=(1, MESH_RANKS), shape=("decode", MAX_SEQ, MESH_B),
            card=got["collectives"]["per_step"]))
        if cfg.name == "qwen3-32b":
            STEP_TIMES[f"qwen3-32b/one-device-decode/{label}"] = \
                want["decode_ms_per_step"]
    launches = summed_launches(ranks)
    emit("mesh", path=f"mesh/{cfg.name}",
         mesh={"data": 1, "model": MESH_RANKS},
         transport="gloo, 4 processes on cuda:0",
         spawn_wall_s_both_models=run["wall"], legs=legs, launches=launches)
    return launches


@contextlib.contextmanager
def arctic_route_spy():
    """Wrap ``moe.route`` (looked up by ``_local_moe`` at each call) inside
    the block, to record per call this shard's assignments and the rows it
    kept."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def spy(cfg, run_cfg, router, x, *, n_local, n_shards, shard_id):
        r = route(cfg, run_cfg, router, x, n_local=n_local,
                  n_shards=n_shards, shard_id=shard_id)
        first = shard_id * n_local
        mine = int(((r.top_e >= first) & (r.top_e < first + n_local)).sum())
        kept = int((r.sel_e < n_local).sum())
        seen.append({"assignments": mine, "kept": kept,
                     "dropped": mine - kept, "capacity": len(r.sel_e)})
        return r

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = route


def mesh_arctic_rank(rank, world, out):
    """One rank of mesh/arctic-480b: (1, 4) expert-parallel (32 experts a
    rank) prefill and decode at capacity factor 8, a prefill at 1.25 with
    the drops recorded, then (2, 2) with FSDP experts."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig, build_model

    rank_begin()
    cfg = replace(get_config("arctic-480b"), n_layers=1, dtype="float32")
    prompt, steps = mesh_tokens(cfg)
    rec = {}
    mesh = S.make_mesh((1, MESH_RANKS), ("data", "model"), "cuda")
    torch.cuda.reset_peak_memory_stats()
    with S.use_mesh(mesh):
        model = build_model(cfg, RunConfig(moe_capacity_factor=8.0),
                            device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                      layer_fan_in=True)
    rec["ep"] = drive_lm(model, prompt, steps[:, :8], timed_pass=True)
    rec["ep"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    model.run = replace(model.run, moe_capacity_factor=1.25)
    with arctic_route_spy() as seen, torch.inference_mode():
        rec["cf1.25"] = {"prefill": model.forward(
            {"tokens": prompt}).float().cpu(), "routes": seen}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mesh = S.make_mesh((2, 2), ("data", "model"), "cuda")
    di = mesh.index("data")
    with S.use_mesh(mesh):
        model = build_model(cfg, RunConfig(moe_capacity_factor=8.0,
                                           fsdp_experts=True,
                                           data_axes=("data",)),
                            device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                      layer_fan_in=True)
    rows = slice(di, di + 1)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.forward({"tokens": prompt[rows]})
        torch.cuda.synchronize()
        rec["fsdp"] = {"prefill": logits.float().cpu(), "rows": rows,
                       "prefill_s": time.perf_counter() - t0,
                       "expert_bytes": sum(
                           model.layers[k].numel()
                           * model.layers[k].element_size()
                           for k in ("e_gate", "e_up", "e_down"))}
    if rank:
        for key in ("ep", "cf1.25"):
            rec[key].pop("prefill"), rec[key].pop("decode", None)
    rank_end(out, rank, rec)


def phase_mesh_arctic(cfg) -> dict:
    """mesh/arctic-480b at full width (128 experts of 7168 x 4864, top-2,
    the dense residual; 56/8 heads of 128), depth 1 in fp32 (a layer is
    53.6 GB on one device, 13.4 GB a rank): on (1, 4) each rank holds 32
    experts; prefill (K2 at 14 local heads) and 8 decode steps with
    ``sharded_decode=False`` (the cache slices gathered, then K1 at 14
    local heads, a group of 7) at capacity factor 8, within the
    reference's EP bound 2e-2 of one device; a prefill at 1.25 with each
    rank's drops recorded (not gated: the capacity T·k/4·1.25 drops other
    tokens than one device's); a prefill on (2, 2) with FSDP experts (the
    FF dimension over data, gathered just in time)."""
    from dataclasses import replace

    from repro_torch.kernels import ops
    from repro_torch.models.api import RunConfig

    cfg = replace(cfg, n_layers=1, dtype="float32")
    prompt, steps = mesh_tokens(cfg)
    want = yardstick_lm(cfg, RunConfig(moe_capacity_factor=8.0), prompt,
                        steps[:, :8], {"layer_fan_in": True})
    ops.reset_launch_counts()             # the yardstick's do not count
    ranks, wall = run_mesh("arctic", mesh_arctic_rank)
    ep = lm_compare("ep-1x4-cf8", ranks[0]["ep"], want, EP_TOL)
    drops = lm_compare("ep-1x4-cf1.25", ranks[0]["cf1.25"], want, EP_TOL,
                       gated=False)
    drops["routes_per_rank"] = [r["cf1.25"]["routes"] for r in ranks]
    fsdp = []
    for r in ranks:
        rec = lm_compare("fsdp-2x2-cf8", r["fsdp"], want, EP_TOL)
        rec.update(prefill_s=r["fsdp"]["prefill_s"],
                   expert_bytes_per_rank=r["fsdp"]["expert_bytes"])
        fsdp.append(rec)
    ep.update(ranks={k: [r["ep"][k] for r in ranks] for k in (
        "prefill_s", "prefill_again_s", "decode_ms_per_step",
        "peak_memory_bytes", "collectives")},
        one_device={k: want[k] for k in (
            "prefill_s", "prefill_again_s", "decode_ms_per_step",
            "peak_memory_bytes")})
    launches = summed_launches(ranks)
    emit("mesh", path="mesh/arctic-480b", n_layers=1, dtype="float32",
         transport="gloo, 4 processes on cuda:0", spawn_wall_s=wall, ep=ep,
         capacity_1_25=drops, fsdp=fsdp, launches=launches)
    return launches


MESH_TRAIN_STEPS = 10
EQUIV_STEPS, EQUIV_CKPT = 4, 2     # fp32 depth-4 steps; checkpoint after 2


def equiv_trainer(cfg, mesh=None, zero1=True):
    """The fp32 depth-4 trainer of the equivalence legs, on per-layer
    fan-in weights (as ``accum_equivalence``): the same draw everywhere."""
    from repro_torch.launch.train import Trainer, run_config

    tr = Trainer(cfg, run_config(zero1=zero1), seq=TRAIN_SEQ,
                 batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED, device="cuda",
                 mesh=mesh, compiled=False)
    tr.model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         layer_fan_in=True)
    return tr


def host_params(tr) -> dict:
    """A host copy of the trainer's parameters (they update in place)."""
    return {k: p.detach().to("cpu", torch.float32, copy=True)
            for k, p in tr.params.items()}


def mesh_train_rank(rank, world, out, ckpt):
    """One rank of mesh/train-smollm-360m on (4, 1) with ZeRO-1: the bf16
    run at full width and depth, then the fp32 depth-4 equivalence legs
    (ZeRO-1 saving a checkpoint after step 2, and plain data parallelism)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import Trainer, run_config

    rank_begin()
    mesh = make_local_mesh(device_type="cuda")
    cfg = get_config("smollm-360m")
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, run_config(zero1=True), seq=TRAIN_SEQ,
                 batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED, device="cuda",
                 mesh=mesh)
    losses, gnorms, step_s = [], [], []
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.step(i)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    rec["bf16"] = {"losses": losses, "grad_norms": gnorms,
                   "step_s": step_s, "moment_bytes": tr.moment_bytes(),
                   "params": sum(p.numel() for p in tr.params.values()),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    with timed_collectives() as tc:
        _, wall = synced(lambda: tr.step(MESH_TRAIN_STEPS))
    rec["bf16"]["collectives"] = collectives_rec(tc, 1, wall)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    small = replace(cfg, n_layers=4, dtype="float32")
    for zero1 in (True, False):
        tr = equiv_trainer(small, mesh, zero1)
        res = {"losses": [], "params": []}
        for i in range(EQUIV_STEPS):
            res["losses"].append(float(tr.step(i)["loss"]))
            if zero1 and i + 1 == EQUIV_CKPT:
                tr.save(ckpt, EQUIV_CKPT)
            if rank == 0:       # every rank ends a step with the whole
                res["params"].append(host_params(tr))
        res["moment_bytes"] = tr.moment_bytes()
        rec["zero1" if zero1 else "dp"] = res
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        # ZeRO-1 against plain data parallelism, step by step, bit for bit
        z, dp = rec["zero1"], rec.pop("dp")
        rec["dp"] = {"losses": dp["losses"],
                     "moment_bytes": dp["moment_bytes"],
                     "params_equal": [all(torch.equal(a[k], b[k]) for k in a)
                                      for a, b in zip(z["params"],
                                                      dp["params"])],
                     "params_vs_zero1": [params_within(b, a) for a, b in
                                         zip(z["params"], dp["params"])]}
    rank_end(out, rank, rec)


def mesh_resume_rank(rank, world, out, ckpt):
    """One rank of the (2, 1) restart: the (4, 1) checkpoint restored into
    a ZeRO-1 trainer on this mesh (each rank reads its slice), then the
    remaining steps."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh

    rank_begin()
    mesh = make_local_mesh(device_type="cuda")
    small = replace(get_config("smollm-360m"), n_layers=4, dtype="float32")
    tr = equiv_trainer(small, mesh)
    t0 = time.perf_counter()
    at = tr.restore(ckpt)
    rec = {"restored_at": at, "restore_s": time.perf_counter() - t0,
           "losses": [float(tr.step(i)["loss"])
                      for i in range(at, EQUIV_STEPS)],
           "moment_bytes": tr.moment_bytes()}
    if rank == 0:
        rec["params"] = host_params(tr)
    rank_end(out, rank, rec)


def params_within(got, want, tight=None) -> dict:
    """Elements of ``got`` outside atol 1e-4 / rtol 1e-3 of ``want``,
    counted over all and, with ``tight`` (per leaf, where the gradient is
    at least 100 · AdamW's eps), over those only."""
    out = {"outside": 0, "outside_tight": 0, "max_abs_diff": 0.0}
    for k, w in want.items():
        over = (got[k] - w).abs() > 1e-4 + 1e-3 * w.abs()
        out["outside"] += int(over.sum())
        out["max_abs_diff"] = max(out["max_abs_diff"],
                                  float((got[k] - w).abs().max()))
        if tight is not None:
            out["outside_tight"] += int((over & tight[k]).sum())
    return out


def phase_mesh_train(cfg) -> dict:
    """mesh/train-smollm-360m on (4, 1) with ZeRO-1: MESH_TRAIN_STEPS steps
    at full width and depth in bf16 (batch 8 x 256, 2 rows a rank, lr
    3e-3): the loss falls, nothing is NaN, the kernel counters read 0; each
    rank's moment bytes against one device's. At fp32 depth 4 on
    per-layer fan-in weights, ZeRO-1 against plain data parallelism on the
    same mesh: the losses and the parameters bit-equal after every step
    (the update is elementwise, so sharding the moments must change no
    bit). Against the single-device trainer on the same batches: the loss
    within rtol 1e-5 at every step, the parameters after the first step
    within atol 1e-4 / rtol 1e-3 wherever the gradient is at least
    100 · eps (``accum_pair``'s split: below it AdamW's first update
    g / (|g| + eps) turns a 1e-9 change of g into a fraction of lr), the
    later steps recorded (the data-parallel gradient is summed in another
    order than one device's, and AdamW carries that into the parameters).
    A checkpoint saved on (4, 1) after step 2, restored on (2, 1) and
    resumed: its losses follow the uninterrupted run within rtol 1e-5."""
    import shutil
    from dataclasses import replace

    from repro_torch.train.train_step import loss_and_grads

    small = replace(cfg, n_layers=4, dtype="float32")
    one = equiv_trainer(small, zero1=False)
    _, grads = loss_and_grads(one.model, one.stream.batch_at(0))
    tight = {k: (g.detach().float().abs() >= 100 * ADAMW_EPS).cpu()
             for k, g in grads.items()}
    del grads
    one_losses, one_params = [], []
    for i in range(EQUIV_STEPS):
        one_losses.append(float(one.step(i)["loss"]))
        one_params.append(host_params(one))
    one_moment_bytes = sum(p.numel() * 8 for p in one.params.values())
    del one
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = os.path.join(MESH_DIR, f"train-ckpt-{os.getpid()}")
    shutil.rmtree(ckpt, ignore_errors=True)
    ranks, wall = run_mesh("train", mesh_train_rank, ckpt)
    resumed, resume_wall = run_mesh("resume", mesh_resume_rank, ckpt,
                                    world=2)
    shutil.rmtree(ckpt)

    bf16 = [r["bf16"] for r in ranks]
    losses = bf16[0]["losses"]
    require(all(math.isfinite(x) for r in bf16
                for x in r["losses"] + r["grad_norms"]),
            "mesh train: non-finite loss or grad norm")
    require(all(r["losses"] == losses for r in bf16),
            "mesh train: the ranks' losses differ")
    require(losses[-1] < losses[0], f"mesh train: loss did not fall: "
                                    f"{losses}")
    full_moments = 8 * bf16[0]["params"]
    z, dp = ranks[0]["zero1"], ranks[0]["dp"]
    require(z["losses"] == dp["losses"] and all(dp["params_equal"])
            and len(dp["params_equal"]) == EQUIV_STEPS,
            f"ZeRO-1 against plain DP: losses {z['losses']} vs "
            f"{dp['losses']}, parameters per step {dp['params_vs_zero1']}")
    for i, (a, b) in enumerate(zip(z["losses"], one_losses)):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"ZeRO-1 step {i + 1} loss {a} vs one device {b}")
    by_step = [params_within(p, q, tight)
               for p, q in zip(z["params"], one_params)]
    require(by_step[0]["outside_tight"] == 0,
            f"ZeRO-1 step 1 parameters vs one device: {by_step[0]}")
    r0 = resumed[0]
    require(all(r["restored_at"] == EQUIV_CKPT for r in resumed),
            "restored step")
    for a, b in zip(r0["losses"], z["losses"][EQUIV_CKPT:]):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"resumed loss {a} vs uninterrupted {b}")
    from repro_torch.launch.train import run_config
    ROOFLINE_LEGS.append(dict(
        path="mesh/train-smollm-360m", leg="bf16", cfg=cfg,
        run=run_config(zero1=True), mesh=(MESH_RANKS, 1),
        shape=("train", TRAIN_SEQ, TRAIN_BATCH), lr=TRAIN_LR,
        card=bf16[0]["collectives"]["per_step"]))
    emit("mesh", path="mesh/train-smollm-360m",
         mesh={"data": MESH_RANKS, "model": 1}, zero1=True,
         transport="gloo, 4 processes on cuda:0", spawn_wall_s=wall,
         bf16={"n_layers": cfg.n_layers, "steps": MESH_TRAIN_STEPS,
               "batch": TRAIN_BATCH, "rows_per_rank":
                   TRAIN_BATCH // MESH_RANKS, "seq": TRAIN_SEQ,
               "lr": TRAIN_LR, "losses": losses,
               "grad_norms": bf16[0]["grad_norms"],
               "step_s_per_rank": [r["step_s"] for r in bf16],
               "steady_step_s": sorted(bf16[0]["step_s"][2:])[
                   len(bf16[0]["step_s"][2:]) // 2],
               "moment_bytes_per_rank": [r["moment_bytes"] for r in bf16],
               "moment_bytes_one_device": full_moments,
               "moment_share": [r["moment_bytes"] / full_moments
                                for r in bf16],
               "peak_memory_bytes": [r["peak_memory_bytes"] for r in bf16],
               "collectives": [r["collectives"] for r in bf16]},
         fp32_depth4={"losses_zero1": z["losses"], "losses_dp": dp["losses"],
                      "losses_one_device": one_losses,
                      "zero1_equals_dp_bitwise": dp["params_equal"],
                      "params_vs_one_device_by_step": by_step,
                      "moment_bytes_zero1_rank0": z["moment_bytes"],
                      "moment_bytes_dp_rank0": dp["moment_bytes"],
                      "moment_bytes_one_device": one_moment_bytes},
         resume={"mesh": {"data": 2, "model": 1}, "spawn_wall_s":
                 resume_wall, "restored_at": r0["restored_at"],
                 "restore_s": [r["restore_s"] for r in resumed],
                 "losses": r0["losses"],
                 "losses_uninterrupted": z["losses"][EQUIV_CKPT:],
                 "params_vs_uninterrupted": params_within(
                     r0["params"], z["params"][-1], tight)})
    return summed_launches(ranks + resumed)


# -- mesh: RWKV6, Zamba2 and Whisper (one spawn for the three) ------------------
#
# Each family at full width on (1, 4), per leg an fp32 cut gated at
# MESH_FP32_TOL against one device and a deeper bf16 cut gated at BF16_TOL
# with the greedy agreement recorded. The three run in one spawn of ranks
# (four processes' start and library load paid once); each rank zeroes its
# launch counters before a family and reads them after it, so every path's
# counts are its own (the ranks' sums).

FAMILY_STEPS = 8        # decode steps a leg, from an empty cache
FAMILY_TIMED = 4        # more steps with the collectives timed
# zamba2's batch-1 cache: 12 positions, so that on (2, 2), where its
# sequence is split over the data axis (6 positions a rank), the decode
# steps write across the ranks' boundary at step 6
ZB1_SMAX = 12
ZB1_PATH = "mesh/zamba2-2.7b-b1"
# zamba2's legs also run the controls of ``plain_control``. Its prefill is
# held to ZAMBA2_PREFILL_TOL, read off them on the card (PERF.md §6):
# at fp32 depth 12 one device's kernels and plain forms sit 6.0e-4 apart,
# one ulp of the weights moves it 5.2e-4, the mesh's plain forms sit 4.8e-4
# from one device's and the mesh 9.1e-4 (the logits reach 5.7), while a
# mix-up of one rank's heads in one mixer moves it by orders more; fp32 is
# held to the bound the one-device legs hold its two arithmetics to
# (FP32_TOL). At bf16 depth 24 one ulp of the weights moves it 2.59 and the
# mesh reads 1.13. Its decode keys keep the legs' limits.
ZAMBA2_PREFILL_TOL = {"fp32-depth12": FP32_TOL, "bf16-depth24": 2.0}
FAMILY_LEGS = {         # label, dtype, depth (None: full), tol, control
    "rwkv6-7b": (("fp32-depth2", "float32", 2, MESH_FP32_TOL, False),
                 ("bf16-depth8", "bfloat16", 8, BF16_TOL, False)),
    "zamba2-2.7b": (("fp32-depth12", "float32", 12, MESH_FP32_TOL, True),
                    ("bf16-depth24", "bfloat16", 24, BF16_TOL, True)),
    "whisper-small": (("fp32-full", "float32", None, MESH_FP32_TOL, False),
                      ("bf16-full", "bfloat16", None, BF16_TOL, False)),
}
FAMILY_INIT = {"rwkv6-7b": {}, "zamba2-2.7b": {"layer_fan_in": True},
               "whisper-small": {"layer_fan_in": True}}


def family_cfg(name, dtype, depth):
    from dataclasses import replace

    from repro_torch.configs import get_config

    cfg = get_config(name)
    return replace(cfg, dtype=dtype, n_layers=depth or cfg.n_layers)


def synced(fn):
    """``fn()`` and its wall seconds, the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_family(model, timed_pass=False, b1_only=False) -> dict:
    """One leg of a family path on ``model`` (one device or a rank):
    RWKV6 and Zamba2 prefill the MESH_B x MESH_S prompt (timed twice) and
    decode FAMILY_STEPS steps from an empty cache, Zamba2 at batch 2 (its
    cache replicated over the model axis on a mesh) and batch 1 (its heads
    sharded, and on data ranks its sequence split; ZB1_SMAX positions);
    Whisper encodes MESH_B x 1500 frames drawn on the card, runs
    ``forward`` over the first 32 prompt tokens, fills the cross cache
    (``prefill_cross``) and decodes FAMILY_STEPS steps. Logits go to the
    host. With ``timed_pass``, FAMILY_TIMED more steps on a fresh cache
    with the collectives timed. ``b1_only``: Zamba2's batch-1 legs alone
    (the prompt's first row)."""
    from repro_torch.configs.base import ShapeSpec

    cfg = model.cfg
    prompt, steps = mesh_tokens(cfg)
    rec = {}
    whisper = cfg.family == "audio"
    with torch.inference_mode():
        if whisper:
            g = torch.Generator(device="cuda").manual_seed(SEED + 3)
            frames = torch.randn((MESH_B, model.enc_seq, cfg.d_model),
                                 generator=g, device="cuda").to(
                                     model.embed.dtype)
            enc, rec["encode_s"] = synced(lambda: model.encode(frames))
            rec["encode"] = enc.float().cpu()
            del enc
            batch = {"frames": frames, "tokens": prompt[:, :32]}
        else:
            batch = {"tokens": prompt[:1] if b1_only else prompt}
        for key in ("prefill_s", "prefill_again_s"):
            logits, rec[key] = synced(lambda: model.forward(batch))
        rec["prefill"] = logits.float().cpu()
        del logits

        def fresh(b):
            smax = ZB1_SMAX if cfg.family == "hybrid" and b == 1 else MAX_SEQ
            cache = model.init_cache(ShapeSpec("mesh", smax, b, "decode"))
            if whisper:
                model.prefill_cross(frames[:b], cache)
            return cache

        batches = (1,) if b1_only else (MESH_B, 1) \
            if cfg.family == "hybrid" else (MESH_B,)
        for b in batches:
            cache, prefill_cross_s = synced(lambda: fresh(b))
            outs = []

            def run():
                for t in range(FAMILY_STEPS):
                    outs.append(model.decode_step(cache, {
                        "tokens": steps[:b, t:t + 1], "cache_len": t})[0])
            _, wall = synced(run)
            key = "decode" if b == MESH_B else f"decode_b{b}"
            rec[key] = torch.stack(outs).float().cpu()
            rec[key + "_ms_per_step"] = wall / FAMILY_STEPS * 1e3
            if whisper:
                rec["prefill_cross_s"] = prefill_cross_s
        if timed_pass:
            tb = 1 if b1_only else MESH_B
            cache = fresh(tb)
            with timed_collectives() as tc:
                def run():
                    for t in range(FAMILY_TIMED):
                        model.decode_step(cache, {
                            "tokens": steps[:tb, t:t + 1], "cache_len": t})
                _, wall = synced(run)
            rec["collectives"] = collectives_rec(tc, FAMILY_TIMED, wall)
    return rec


def drive_plain(model, b1_only=False) -> dict:
    """``drive_family``'s logits on the plain forms of the same weights
    (``attn_impl="plain"``): the control that says how far two sound
    arithmetics of the model sit apart."""
    from dataclasses import replace

    run = model.run
    model.run = replace(run, attn_impl="plain")
    try:
        rec = drive_family(model, b1_only=b1_only)
    finally:
        model.run = run
    return {k: rec[k] for k in ("prefill", "decode", "decode_b1") if k in rec}


def ulp_nudge(model, seed) -> None:
    """Moves every floating parameter of ``model`` by one ulp, up or down
    at random from ``seed`` (zeros stay): what one rounding of the weights
    does, the floor against which a mesh's other rounding is read."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.dtype in ints:
                bits = t.view(ints[t.dtype])
                step = torch.randint(0, 2, t.shape, generator=g,
                                     device=t.device, dtype=bits.dtype)
                bits.add_(torch.where(t != 0, 2 * step - 1, 0))


def rank_fault(model, undo=False) -> None:
    """Zamba2's first mixer reading its SSD decays (``A_log``) from the next
    rank's heads, a rank's share away (``undo`` puts them back): the fault
    a mix-up of one rank's heads makes, which a leg's limit must see."""
    with torch.no_grad():
        a = model.mamba["A_log"][0, 0]
        shift = a.shape[0] // MESH_RANKS
        a.copy_(a.roll(-shift if undo else shift))


def family_model(name, dtype, depth, mesh=None):
    from repro_torch.models.api import RunConfig, build_model
    from repro_torch.models import sharding as S

    with S.use_mesh(mesh):
        model = build_model(family_cfg(name, dtype, depth), RunConfig(),
                            device="cuda")
    return model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED),
        **FAMILY_INIT[name])


def mesh_families_rank(rank, world, out):
    """One rank of the three family paths on (data 1, model 4), then of
    Zamba2's batch-1 path on (2, 2): each path's legs with this rank's
    launch counters zeroed before it and read after it."""
    from repro_torch.kernels import ops
    from repro_torch.models import sharding as S

    rank_begin()
    mesh = S.make_mesh((1, MESH_RANKS), ("data", "model"), "cuda")
    rec = {}
    for name, legs in FAMILY_LEGS.items():
        ops.reset_launch_counts()
        fam = {}
        for label, dtype, depth, _, control in legs:
            torch.cuda.reset_peak_memory_stats()
            model = family_model(name, dtype, depth, mesh)
            res = drive_family(model, timed_pass=True)
            res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            if control:
                res["plain"] = drive_plain(model)
            if rank:
                for k in ("encode", "prefill", "decode", "decode_b1",
                          "plain"):
                    res.pop(k, None)
            fam[label] = res
            del model
            gc.collect()
            torch.cuda.empty_cache()
        fam["launches"] = ops.launch_counts()
        rec[name] = fam
    # Zamba2's batch 1 on (2, 2): the cache's sequence over the data axis,
    # its heads (16 of 32) and SSD heads (40 of 80) over the model axis
    mesh = S.make_mesh((2, 2), ("data", "model"), "cuda")
    ops.reset_launch_counts()
    fam = {}
    for label, dtype, depth, _, _ in FAMILY_LEGS["zamba2-2.7b"]:
        torch.cuda.reset_peak_memory_stats()
        model = family_model("zamba2-2.7b", dtype, depth, mesh)
        res = drive_family(model, timed_pass=True, b1_only=True)
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        res["plain"] = drive_plain(model, b1_only=True)
        if rank:
            for k in ("prefill", "decode_b1", "plain"):
                res.pop(k, None)
        fam[label] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    fam["launches"] = ops.launch_counts()
    rec[ZB1_PATH] = fam
    rank_end(out, rank, rec)


_FAMILY_RANKS = {}


def mesh_families_spawn() -> dict:
    """The yardsticks (one device, each built and freed in turn), then one
    spawn of ranks for the three families; cached for the three paths."""
    from repro_torch.kernels import ops

    if not _FAMILY_RANKS:
        want = {}

        def one_device(name, dtype, depth, control=False):
            torch.cuda.reset_peak_memory_stats()
            model = family_model(name, dtype, depth)
            rec = drive_family(model)
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            if control:
                rec["plain"] = drive_plain(model)
                keys = ("prefill", "decode", "decode_b1")
                rank_fault(model)
                rec["fault"] = {k: v for k, v in drive_family(model).items()
                                if k in keys}
                rank_fault(model, undo=True)
                ulp_nudge(model, SEED + 7)
                rec["ulp"] = {k: v for k, v in drive_family(model).items()
                              if k in keys}
            del model
            gc.collect()
            torch.cuda.empty_cache()
            return rec

        for name, legs in FAMILY_LEGS.items():
            for label, dtype, depth, _, control in legs:
                want[name, label] = one_device(name, dtype, depth, control)
        ops.reset_launch_counts()             # the yardsticks' do not count
        ranks, wall = run_mesh("families", mesh_families_rank)
        _FAMILY_RANKS.update(want=want, ranks=ranks, wall=wall)
    return _FAMILY_RANKS


def plain_control(got, one, keys=("prefill", "decode", "decode_b1"),
                  rows=slice(None)) -> dict:
    """The mesh's distance from one device beside four controls: one
    device on the kernels against one device on the plain forms, the mesh
    on the plain forms against one device on them, one device with every
    weight moved by one ulp (``ulp_nudge``) and one device with one rank's
    heads mixed up (``rank_fault``), each against one device (its prefill
    cut to ``rows``, those the mesh prefilled). The prefill's distance also
    by position (the largest of each block of FAMILY_STEPS positions): the
    decode legs see the first FAMILY_STEPS."""
    def mine(rec, key):
        return rec[key][rows] if key == "prefill" else rec[key]

    out = {}
    for key in keys:
        want = mine(one, key)
        out[key] = {
            "mesh_vs_one": max_abs_err(got[key], want),
            "one_kernels_vs_plain": max_abs_err(want,
                                                mine(one["plain"], key)),
            "mesh_plain_vs_one_plain": max_abs_err(got["plain"][key],
                                                   mine(one["plain"], key)),
            "one_ulp_vs_one": max_abs_err(mine(one["ulp"], key), want),
            "one_fault_vs_one": max_abs_err(mine(one["fault"], key), want)}
    d = (got["prefill"] - mine(one, "prefill")).abs().amax(dim=(0, 2))
    out["prefill_by_position_block"] = [
        float(b.max()) for b in d.split(FAMILY_STEPS)]
    out["logits_max_abs"] = float(one["prefill"].abs().max())
    return out


def phase_mesh_family(cfg) -> dict:
    """mesh/rwkv6-7b (d 4096, 64 heads: K3 at 16 local heads, the wkv
    state the rank's heads, the group norm's moments gathered),
    mesh/zamba2-2.7b (80 SSD heads: K4 at 20 local heads behind the
    resharded in_proj; the shared attention's K2 and K1 at 8 of 32 heads of
    80; batch 2 on the replicated KV cache, batch 1 on the head-sharded
    one; ``layer_fan_in`` weights, ROADMAP §C3) or mesh/whisper-small
    (12 + 12 layers, 1500 frames: K2 causal, non-causal and cross and K1
    on the self and the 1500-long cross cache at 3 of 12 heads;
    ``layer_fan_in`` weights, ROADMAP §C9), each on (1, 4) against one
    device on the same weights."""
    run = mesh_families_spawn()
    ranks, want = run["ranks"], run["want"]
    legs = []
    for label, dtype, depth, tol, control in FAMILY_LEGS[cfg.name]:
        got = ranks[0][cfg.name][label]
        one = want[cfg.name, label]
        # every comparison is made (and printed) before any gate is read
        rec = lm_compare(label, {k: got[k] for k in ("prefill", "decode")},
                         one, tol, gated=False)
        if "decode_b1" in got:
            b1 = lm_compare(label + "-b1", {"decode": got["decode_b1"]},
                            {"decode": one["decode_b1"]}, tol, gated=False)
            rec.update({f"b1_{k}": v for k, v in b1.items()
                        if k.startswith("decode")})
        if "encode" in got:
            rec["encode_max_abs_err"] = max_abs_err(got["encode"],
                                                    one["encode"])
        if control:
            rec["control"] = plain_control(got, one)
            rec["prefill_tol"] = ZAMBA2_PREFILL_TOL[label]
        ROOFLINE_LEGS.append(dict(
            path=f"mesh/{cfg.name}", leg=label,
            cfg=family_cfg(cfg.name, dtype, depth), run=None,
            mesh=(1, MESH_RANKS), shape=("decode", MAX_SEQ, MESH_B),
            card=got["collectives"]["per_step"]))
        times = [k for k in got if k.endswith(("_s", "_ms_per_step"))]
        rec.update(n_layers=depth or cfg.n_layers, dtype=dtype,
                   ranks={k: [r[cfg.name][label][k] for r in ranks]
                          for k in times + ["peak_memory_bytes",
                                            "collectives"]},
                   one_device={k: one[k] for k in times
                               + ["peak_memory_bytes"]})
        legs.append(rec)
    launches = summed_launches([r[cfg.name] for r in ranks])
    emit("mesh", path=f"mesh/{cfg.name}",
         mesh={"data": 1, "model": MESH_RANKS},
         transport="gloo, 4 processes on cuda:0",
         spawn_wall_s_all_families=run["wall"], legs=legs, launches=launches)
    for rec in legs:
        for key in ("prefill_max_abs_err", "decode_max_abs_err",
                    "b1_decode_max_abs_err", "encode_max_abs_err"):
            tol = rec.get("prefill_tol", rec["tol"]) \
                if key == "prefill_max_abs_err" else rec["tol"]
            require(rec.get(key, 0.0) <= tol,
                    f"{rec['leg']}: {key} {rec.get(key)} > {tol}")
        if "control" in rec:        # the limit sees a rank's heads mixed up
            fault = rec["control"]["prefill"]["one_fault_vs_one"]
            require(fault > rec["prefill_tol"],
                    f"{rec['leg']}: a rank fault moves the prefill {fault}, "
                    f"within the limit {rec['prefill_tol']}")
    return launches


def phase_mesh_zamba2_b1(cfg) -> dict:
    """mesh/zamba2-2.7b-b1: Zamba2 with a batch of 1 on (data 2, model 2),
    the reference's long_500k layout at full width: the KV cache's
    sequence split over the data axis (ZB1_SMAX positions, 6 a rank, so
    the decode steps write across the ranks' boundary at step 6) and its
    heads over the model axis (16 of 32 heads of 80; the distributed
    flash-decode on K1 with the lse, merged over the data axis), the SSD
    (K4 at 40 of 80 heads in the prefill) and conv states over the model
    axis and replicated over the data axis. Each leg (the family's fp32
    depth 12 and bf16 depth 24) prefills the prompt's first row and
    decodes FAMILY_STEPS steps, against one device (its batch-2 prefill's
    first row, its batch-1 decode) with the controls of the (1, 4) legs
    and their limits: the prefill's ZAMBA2_PREFILL_TOL, which the rank
    fault must break, and the legs' decode limit."""
    run = mesh_families_spawn()
    ranks = [r[ZB1_PATH] for r in run["ranks"]]
    legs = []
    for label, dtype, depth, tol, _ in FAMILY_LEGS[cfg.name]:
        got, one = ranks[0][label], run["want"][cfg.name, label]
        rec = {"leg": label, "tol": tol,
               "prefill_tol": ZAMBA2_PREFILL_TOL[label],
               "control": plain_control(got, one, ("prefill", "decode_b1"),
                                        slice(0, 1))}
        for key, want in (("prefill", one["prefill"][:1]),
                          ("decode_b1", one["decode_b1"])):
            rec[f"{key}_max_abs_err"] = max_abs_err(got[key], want)
            rec[f"{key}_greedy_agree"] = float(
                (got[key].argmax(-1) == want.argmax(-1)).float().mean())
        times = [k for k in got if k.endswith(("_s", "_ms_per_step"))]
        rec.update(n_layers=depth, dtype=dtype,
                   ranks={k: [r[label][k] for r in ranks]
                          for k in times + ["peak_memory_bytes",
                                            "collectives"]})
        legs.append(rec)
        ROOFLINE_LEGS.append(dict(
            path=ZB1_PATH, leg=label, cfg=family_cfg(cfg.name, dtype, depth),
            run=None, mesh=(2, 2), shape=("decode", ZB1_SMAX, 1),
            card=got["collectives"]["per_step"]))
    launches = summed_launches(ranks)
    emit("mesh", path=ZB1_PATH, mesh={"data": 2, "model": 2},
         transport="gloo, 4 processes on cuda:0",
         spawn_wall_s_all_families=run["wall"], legs=legs, launches=launches)
    for rec in legs:
        require(rec["prefill_max_abs_err"] <= rec["prefill_tol"],
                f"{rec['leg']}: b1 prefill {rec['prefill_max_abs_err']} > "
                f"{rec['prefill_tol']}")
        require(rec["decode_b1_max_abs_err"] <= rec["tol"],
                f"{rec['leg']}: b1 decode {rec['decode_b1_max_abs_err']} > "
                f"{rec['tol']}")
        fault = rec["control"]["prefill"]["one_fault_vs_one"]
        require(fault > rec["prefill_tol"],
                f"{rec['leg']}: a rank fault moves the prefill {fault}, "
                f"within the limit {rec['prefill_tol']}")
    return launches


# -- mesh: tensor-parallel training (qwen3-32b) -----------------------------------

QWEN3_TRAIN_DEPTH = 1       # 2.05 B parameters: see phase_mesh_train_qwen3
QWEN3_TRAIN_STEPS = 3
QWEN3_TRAIN_BATCH = 2
QWEN3_TRAIN_LR = 3e-4       # the reference's build_step default
QWEN3_SNAPSHOTS = (1, 3)    # steps after which parameters are compared
QWEN3_TRAIN_LEGS = (("tp-1x4", (1, 4), False), ("tp-zero1-2x2", (2, 2), True))


def qwen3_trainer(cfg, mesh=None, zero1=False):
    from repro_torch.launch.train import Trainer, run_config

    tr = Trainer(cfg, run_config(zero1=zero1), seq=TRAIN_SEQ,
                 batch=QWEN3_TRAIN_BATCH, lr=QWEN3_TRAIN_LR, seed=SEED,
                 device="cuda", mesh=mesh, compiled=False)
    tr.model.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         layer_fan_in=True)
    return tr


def snapshot_path(snap, step, name):
    return os.path.join(snap, f"{step}.{name}.npy")


def mesh_train_qwen3_rank(rank, world, out, snap):
    """One rank of mesh/train-qwen3-32b: per leg QWEN3_TRAIN_STEPS steps
    (the last with the collectives timed), and after each of
    QWEN3_SNAPSHOTS this rank's parameter shards against its slice of the
    one-device run's (memory-mapped from ``snap``). A leaf's elements are
    counted on the ranks whose coordinate is 0 on every axis that does not
    shard it, so each element counts once."""
    import numpy as np

    from repro_torch.models import sharding as S

    rank_begin()
    cfg = family_cfg("qwen3-32b", "float32", QWEN3_TRAIN_DEPTH)
    rec = {}
    for label, shape, zero1 in QWEN3_TRAIN_LEGS:
        mesh = S.make_mesh(shape, ("data", "model"), "cuda")
        torch.cuda.reset_peak_memory_stats()
        tr = qwen3_trainer(cfg, mesh, zero1)
        specs = tr.model.param_pspecs()
        full = tr.model.param_shapes()
        leg = {"losses": [], "grad_norms": [], "step_s": [], "params": {}}
        for i in range(QWEN3_TRAIN_STEPS):
            last = i + 1 == QWEN3_TRAIN_STEPS
            with contextlib.ExitStack() as stack:
                tc = stack.enter_context(timed_collectives()) if last \
                    else None
                m, wall = synced(lambda: tr.step(i))
            leg["losses"].append(float(m["loss"]))
            leg["grad_norms"].append(float(m["grad_norm"]))
            leg["step_s"].append(wall)
            if last:
                leg["collectives"] = collectives_rec(tc, 1, wall)
            if i + 1 not in QWEN3_SNAPSHOTS:
                continue
            counts = {"outside": 0, "outside_tight": 0, "elements": 0,
                      "max_abs_diff": 0.0}
            for k, p in tr.params.items():
                own = {a for e in specs[k] for a in S.entry_axes(e)}
                if any(mesh.coord[a] for a in mesh.axis_names
                       if a not in own):
                    continue
                sl = S.local_slices(full[k][0], specs[k], mesh, k)
                w, t = (torch.from_numpy(np.array(np.load(
                    snapshot_path(snap, s, k), mmap_mode="r")[sl])).cuda()
                    for s in (i + 1, "tight"))
                g = p.detach().float()
                over = (g - w).abs() > 1e-4 + 1e-3 * w.abs()
                counts["outside"] += int(over.sum())
                counts["outside_tight"] += int((over & t).sum())
                counts["elements"] += w.numel()
                counts["max_abs_diff"] = max(counts["max_abs_diff"],
                                             float((g - w).abs().max()))
                del w, t, g, over
            leg["params"][i + 1] = counts
        leg["moment_bytes"] = tr.moment_bytes()
        leg["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        rec[label] = leg
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    rank_end(out, rank, rec)


def phase_mesh_train_qwen3(cfg) -> dict:
    """mesh/train-qwen3-32b: the training step tensor-parallel at full
    width (d 5120, 64/8 heads of 128, d_ff 25600, vocab 151936) in fp32,
    depth QWEN3_TRAIN_DEPTH, batch 2 x 256, lr 3e-4, the plain attention
    forms, on per-layer fan-in weights: on (1, 4), and on (2, 2) with
    ZeRO-1 (the moments' unsharded dimension over data). Depth 1 is 2.05 B
    parameters, 8.2 GB in fp32 and 33 GB with the gradients and the AdamW
    moments on one device; on (2, 2) a rank holds half of every sharded
    leaf (the vocabulary-split embedding and head are 1.56 B of the 2.05 B)
    and a quarter of the moments, ~18 GB at its peak, ~72 GB over the four
    ranks with their CUDA contexts: depth 2 would not fit beside it. Gate,
    as mesh/train-smollm-360m's: every step's loss within rtol 1e-5 of one
    device's; after step 1 the parameters within atol 1e-4 / rtol 1e-3
    where the step-1 gradient is at least 100 · eps; after step 3 the
    count outside recorded. The one-device run goes first and is freed;
    its parameters reach the ranks as .npy files they memory-map."""
    import shutil

    import numpy as np

    from repro_torch.train.train_step import loss_and_grads

    small = family_cfg(cfg.name, "float32", QWEN3_TRAIN_DEPTH)
    snap = os.path.join(MESH_DIR, f"qwen3-train-{os.getpid()}")
    shutil.rmtree(snap, ignore_errors=True)
    os.makedirs(snap)
    torch.cuda.reset_peak_memory_stats()
    one = qwen3_trainer(small)
    _, grads = loss_and_grads(one.model, one.stream.batch_at(0))
    for k, g in grads.items():
        np.save(snapshot_path(snap, "tight", k),
                (g.detach().abs() >= 100 * ADAMW_EPS).cpu().numpy())
    del grads
    one_rec = {"losses": [], "step_s": []}
    for i in range(QWEN3_TRAIN_STEPS):
        m, wall = synced(lambda: one.step(i))
        one_rec["losses"].append(float(m["loss"]))
        one_rec["step_s"].append(wall)
        if i + 1 in QWEN3_SNAPSHOTS:
            for k, p in one.params.items():
                np.save(snapshot_path(snap, i + 1, k),
                        p.detach().float().cpu().numpy())
    one_rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    one_rec["params"] = sum(p.numel() for p in one.params.values())
    one_rec["moment_bytes"] = one.moment_bytes()
    del one
    gc.collect()
    torch.cuda.empty_cache()

    ranks, wall = run_mesh("train-qwen3", mesh_train_qwen3_rank, snap)
    shutil.rmtree(snap)
    from repro_torch.launch.train import run_config
    legs = []
    for label, shape, zero1 in QWEN3_TRAIN_LEGS:
        per = [r[label] for r in ranks]
        ROOFLINE_LEGS.append(dict(
            path="mesh/train-qwen3-32b", leg=label, cfg=small,
            run=run_config(zero1=zero1), mesh=shape,
            shape=("train", TRAIN_SEQ, QWEN3_TRAIN_BATCH), lr=QWEN3_TRAIN_LR,
            card=per[0]["collectives"]["per_step"]))
        losses = per[0]["losses"]
        require(all(math.isfinite(x) for r in per
                    for x in r["losses"] + r["grad_norms"]),
                f"{label}: non-finite loss or grad norm")
        require(all(r["losses"] == losses for r in per),
                f"{label}: the ranks' losses differ")
        for i, (a, b) in enumerate(zip(losses, one_rec["losses"])):
            require(abs(a - b) <= 1e-5 * abs(b),
                    f"{label} step {i + 1}: loss {a} vs one device {b}")
        params = {s: {k: sum(r["params"][s][k] for r in per)
                      if k != "max_abs_diff" else
                      max(r["params"][s][k] for r in per)
                      for k in per[0]["params"][s]} for s in QWEN3_SNAPSHOTS}
        require(params[1]["elements"] == one_rec["params"],
                f"{label}: compared {params[1]['elements']} elements of "
                f"{one_rec['params']}")
        require(params[1]["outside_tight"] == 0,
                f"{label}: step-1 parameters vs one device: {params[1]}")
        legs.append({"leg": label, "mesh": dict(zip(("data", "model"),
                                                    shape)),
                     "zero1": zero1, "losses": losses,
                     "losses_one_device": one_rec["losses"],
                     "grad_norms": per[0]["grad_norms"],
                     "params_vs_one_device_by_step": params,
                     "step_s_per_rank": [r["step_s"] for r in per],
                     "collectives": [r["collectives"] for r in per],
                     "moment_bytes_per_rank": [r["moment_bytes"]
                                               for r in per],
                     "peak_memory_bytes": [r["peak_memory_bytes"]
                                           for r in per]})
    emit("mesh", path="mesh/train-qwen3-32b", n_layers=QWEN3_TRAIN_DEPTH,
         dtype="float32", batch=QWEN3_TRAIN_BATCH, seq=TRAIN_SEQ,
         lr=QWEN3_TRAIN_LR, transport="gloo, 4 processes on cuda:0",
         spawn_wall_s=wall, one_device=one_rec, legs=legs)
    return summed_launches(ranks)


# -- phase: roofline ---------------------------------------------------------------

def phase_roofline(serve_records) -> None:
    """The dry run's counts against the card's runs. Every timed leg of a
    mesh path: ``launch/dryrun.py``'s count of the same step (its model,
    depth, dtype, run config, batch and cache, on meta tensors, as rank 0
    of a fake process group of the leg's mesh) must equal the collectives
    the card's step ran, kind by kind (the bytes printed beside). Then
    smollm-360m's serve step (8 busy slots), its training step and
    qwen3-32b's one-device decode: the counted compute term (FLOPs at the
    dtype's peak) and memory term (unfused bytes at HBM3's rate; both
    roofline.py's) of the plain forms beside the measured step time."""
    from dataclasses import replace

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import run_config
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig, build_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_train_step

    def spec(kind, seq, batch):
        return ShapeSpec(kind, seq, batch, kind)

    rows = []
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=MESH_RANKS)
    try:
        meshes = {}
        for leg in ROOFLINE_LEGS:
            if leg["mesh"] not in meshes:
                meshes[leg["mesh"]] = S.make_mesh(leg["mesh"],
                                                  ("data", "model"), "cpu")
            mesh = meshes[leg["mesh"]]
            run = leg["run"] if isinstance(leg["run"], RunConfig) \
                else RunConfig(**(leg["run"] or {}))
            with S.use_mesh(mesh):
                call = dryrun.prepare(leg["cfg"].name, spec(*leg["shape"]),
                                      mesh, replace(run, attn_impl="plain"),
                                      leg["cfg"])[0]
                dry = dryrun.counted(call)["collectives"]
            rows.append({
                "path": leg["path"], "leg": leg["leg"], "mesh": leg["mesh"],
                "dry_run": {k: (v["count"], v["bytes"]) for k, v in
                            dry.items()},
                "card": {k: (v["count"], v["bytes"]) for k, v in
                         leg["card"].items()},
                "counts_equal": {k: v["count"] for k, v in dry.items()}
                == {k: v["count"] for k, v in leg["card"].items()}})
    finally:
        dist.destroy_process_group()

    terms = []

    def term(name, dtype, call, measured_ms):
        c = dryrun.counted(call)
        terms.append({
            "step": name, "dtype": dtype, "flops": c["flops"],
            "bytes": c["bytes_accessed"],
            "compute_ms": c["flops"] / roofline.peak_flops(dtype) * 1e3,
            "memory_ms": c["bytes_accessed"] / roofline.HBM_BW * 1e3,
            "measured_ms": measured_ms})

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    plain = RunConfig(attn_impl="plain")
    cfg = get_config("smollm-360m")
    model = build_model(cfg, plain, device="meta")
    cache = model.init_cache(spec("decode", MAX_SEQ, MAX_SLOTS))
    with torch.no_grad():
        term("serve/smollm-360m (8 slots)", cfg.dtype,
             lambda: model.decode_step(cache, {
                 "tokens": meta(MAX_SLOTS, 1),
                 "cache_len": meta(MAX_SLOTS, dtype=torch.long)}),
             serve_records["smollm-360m"]["steady_state"]["ms_per_step"])
    model = build_model(cfg, run_config(), device="meta")
    step = make_train_step(model, lr=TRAIN_LR)
    opt = adamw_init(dict(model.named_parameters()))
    batch = {"tokens": meta(TRAIN_BATCH, TRAIN_SEQ),
             "labels": meta(TRAIN_BATCH, TRAIN_SEQ)}
    term("train/smollm-360m", cfg.dtype, lambda: step(opt, batch, None),
         STEP_TIMES["train/smollm-360m"])
    for label, dtype, depth, _ in LM_LEGS:
        model = build_model(family_cfg("qwen3-32b", dtype, depth), plain,
                            device="meta")
        cache = model.init_cache(spec("decode", MAX_SEQ, MESH_B))
        with torch.no_grad():
            term(f"qwen3-32b/one-device-decode/{label}", dtype,
                 lambda: model.decode_step(cache, {
                     "tokens": meta(MESH_B, 1), "cache_len": meta()}),
                 STEP_TIMES[f"qwen3-32b/one-device-decode/{label}"])
    emit("roofline", card=roofline.CARD, legs=rows, one_device=terms)
    for row in rows:
        require(row["counts_equal"],
                f"roofline: {row['path']} {row['leg']}: the dry run counts "
                f"{row['dry_run']}, the card ran {row['card']}")


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
    # not a Pallas kernel: lax.ragged_dot, the MoE's grouped GEMM
    "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                       "src/repro/models/moe.py:128"),
    # lax.ragged_dot twice (gate, up) and silu(g) * u, fused
    "grouped_swiglu": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                       "src/repro/models/moe.py:128"),
    # not a Pallas kernel: the reference decodes in jnp
    "wkv6_decode": ("src/repro_torch/kernels/csrc/wkv6_decode.cu",
                    "src/repro/kernels/chunked.py:88"),
    # none: XLA fuses the reference's elementwise passes itself
    "add_rms_norm": ("src/repro_torch/kernels/csrc/fused_decode.cu",
                     "src/repro/models/layers.py::rms_norm"),
    "rope_kv_write": ("src/repro_torch/kernels/csrc/fused_decode.cu",
                      "src/repro/models/layers.py::rotate"),
    "silu_mul": ("src/repro_torch/kernels/csrc/fused_decode.cu",
                 "src/repro/models/layers.py::swiglu"),
}
FUSED = ("add_rms_norm", "rope_kv_write", "silu_mul")
# the kernels each path must launch
# (DecoderLM's decode steps with per-row lengths on one device launch the
# fused passes; the MoE's MLP is not silu_mul's)
PATH_KERNELS = {"smollm-360m": ("decode_attention", "flash_attention",
                                *FUSED),
                "rwkv6-7b": ("wkv6", "wkv6_decode"),
                "zamba2-2.7b": ("decode_attention", "flash_attention", "ssd"),
                "arctic-480b": ("decode_attention", "flash_attention",
                                "grouped_matmul", "grouped_swiglu",
                                *FUSED[:2]),
                "kimi-k2-1t-a32b": ("decode_attention", "flash_attention",
                                    "grouped_matmul", "grouped_swiglu",
                                    *FUSED[:2]),
                "qwen2-vl-72b": ("decode_attention", "flash_attention",
                                 *FUSED),
                # the parent's in-process replicas that check the children
                "smollm-360m/container": ("decode_attention", *FUSED),
                "whisper-small": ("decode_attention", "flash_attention"),
                # training runs the plain forms: these must launch nothing
                "train/smollm-360m": (),
                "train/whisper-small": (),
                "launch/serve": ("decode_attention", *FUSED),
                "churn-live/smollm-360m": ("decode_attention", *FUSED),
                # four ranks on cuda:0 over gloo; the counts are the ranks'
                "mesh/qwen3-32b": ("decode_attention", "flash_attention"),
                "mesh/smollm-360m": ("decode_attention", "flash_attention"),
                "mesh/arctic-480b": ("decode_attention", "flash_attention",
                                     "grouped_matmul", "grouped_swiglu"),
                "mesh/train-smollm-360m": (),
                "mesh/rwkv6-7b": ("wkv6", "wkv6_decode"),
                "mesh/zamba2-2.7b": ("decode_attention", "flash_attention",
                                     "ssd"),
                "mesh/whisper-small": ("decode_attention", "flash_attention"),
                ZB1_PATH: ("decode_attention", "flash_attention", "ssd"),
                "mesh/train-qwen3-32b": ()}
NO_KERNEL_PATHS = ("train/smollm-360m", "train/whisper-small",
                   "mesh/train-smollm-360m", "mesh/train-qwen3-32b")


def run_path(name, serve_records) -> dict:
    """One configuration's path, with the launch counters zeroed just
    before it and read just after it. Depth is full except where a leg says
    otherwise; weights are drawn from the seed. A serve phase's line goes
    into ``serve_records`` under its configuration's name."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    head, _, tail = name.partition("/")
    cname = {"launch/serve": None,
             "mesh/train-smollm-360m": "smollm-360m",
             "mesh/train-qwen3-32b": "qwen3-32b",
             ZB1_PATH: "zamba2-2.7b"}.get(
        name, tail if head in ("train", "launch", "mesh", "churn-live")
        else head)
    cfg = get_config(cname) if cname else None
    ops.reset_launch_counts()
    mesh_phase = {"mesh/qwen3-32b": phase_mesh_lm,
                  "mesh/smollm-360m": phase_mesh_lm,
                  ZB1_PATH: phase_mesh_zamba2_b1,
                  "mesh/arctic-480b": phase_mesh_arctic,
                  "mesh/train-smollm-360m": phase_mesh_train,
                  "mesh/rwkv6-7b": phase_mesh_family,
                  "mesh/zamba2-2.7b": phase_mesh_family,
                  "mesh/whisper-small": phase_mesh_family,
                  "mesh/train-qwen3-32b": phase_mesh_train_qwen3}.get(name)
    if mesh_phase is not None:
        counts = mesh_phase(cfg)
        require(not any(ops.launch_counts().values()),
                f"{name}: this process launched kernels")
    elif name == "smollm-360m":
        phase_model(cfg, fp32_depth=4)
        serve_records[name] = phase_serve(cfg)
        phase_cache_owners(cfg)
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
    elif name == "kimi-k2-1t-a32b":
        # 384 experts of 7168 x 2048 x 3 are 33.8 GB a layer in bf16, with
        # 4.7 GB of embedding and head: depth 1 in bf16 only (fp32 would be
        # ~78 GB); serve keeps one replica alive at a time
        phase_model(cfg, fp32_depth=None, bf16_depth=1)
        phase_serve(replace(cfg, n_layers=1), max_scale=1,
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
    elif name == "churn-live/smollm-360m":
        phase_churn_live(cfg)
    else:
        phase_launch_serve()
    if mesh_phase is None:
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
    paths, seconds = {}, {"build_and_kernels": time.perf_counter() - t_start}
    for name in PATH_KERNELS:
        t0 = time.perf_counter()
        paths[name] = run_path(name, serve_records)
        seconds[name] = time.perf_counter() - t0
    emit("launches", paths=paths, seconds=seconds)
    phase_roofline(serve_records)

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
