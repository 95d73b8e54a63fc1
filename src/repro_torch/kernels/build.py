"""Builds ``csrc/*.cu`` with ``nvcc`` and loads the result with ``ctypes``.

The sources have a plain C interface (no PyTorch headers), so the build
takes seconds. Each source is compiled to an object file by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library. The library lives in a build directory keyed by a hash of
every file under ``csrc/`` and of the compiler flags, so a stale library is
never loaded. Nothing is built at import time: the first kernel launch (or
an explicit ``load()``) triggers the build.

Build directory: ``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/`` at the
root of the checkout that holds this package.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch import trace

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
LIB_NAME = "librepro_torch_kernels.so"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None    # wall time of this process's build
build_log: str = ""                      # nvcc's output (ptxas -v when asked)


class KernelBuildError(RuntimeError):
    pass


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built on this host")


def source_hash(flags=()) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(list(NVCC_FLAGS) + list(flags)).encode())
    return h.hexdigest()[:16]


def is_built(root=None) -> bool:
    """Whether the library of the current sources is already in ``root``
    (default: ``build_root()``), so that a process loading from there
    builds nothing. Container mode reads it to tell a cold creation from a
    warm one."""
    root = build_root() if root is None else Path(root)
    return (root / f"kernels-{source_hash()}" / LIB_NAME).exists()


def build(verbose_ptxas: bool = False) -> Path:
    """Compile and link the library if its hash directory does not hold it
    yet; returns the library's path. Raises ``KernelBuildError`` with
    ``nvcc``'s output when a source does not compile."""
    global build_seconds, build_log
    extra = ["-Xptxas", "-v"] if verbose_ptxas else []
    out_dir = build_root() / f"kernels-{source_hash(extra)}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    # private scratch inside the build directory; the finished library is
    # moved into place atomically so a concurrent process never loads half
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise KernelBuildError(
                f"nvcc failed for {', '.join(failed)}:\n{build_log}")
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes for every exported launcher: without them ctypes passes a
    pointer as a 32-bit int and cuts it."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_decode_attention.restype = ci
    lib.repro_decode_attention.argtypes = [
        vp, vp, vp, vp, vp, vp,      # q, k_cache, v_cache, lens, out, lse
        vp, vp,                      # split partials, split counters
        ci, ci, ci, ci, ci,          # B, Smax, Hq, Hkv, D
        ci, ci,                      # nsplit, chunk
        ci, cf, vp]                  # is_bf16, scale, stream
    lib.repro_flash_attention.restype = ci
    lib.repro_flash_attention.argtypes = [
        vp, vp, vp, vp,              # q, k, v, out
        ci, ci, ci, ci, ci, ci,      # B, Sq, Skv, Hq, Hkv, D
        ci, ci, ci, cf, vp]          # causal, q_offset, is_bf16, scale, stream
    lib.repro_wkv6_chunk.restype = ci
    lib.repro_wkv6_chunk.argtypes = [
        vp, vp, vp, vp, vp, vp,      # r, k, v, w, u, s0
        vp, vp,                      # y, s_out
        ci, ci, ci, ci, ci, ci,      # B, S, H, dk, dv, chunk
        ci, ci, vp]                  # is_bf16, design, stream
    lib.repro_wkv6_decode.restype = ci
    lib.repro_wkv6_decode.argtypes = [
        vp, vp, vp, vp, vp,          # r, k, v, w, u
        vp, vp, vp,                  # state (in place), lens, y
        ci, ci, ci, ci,              # B, H, dk, dv
        ci, vp]                      # is_bf16, stream
    cl = ctypes.c_longlong
    lib.repro_ssd_chunk.restype = ci
    lib.repro_ssd_chunk.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,  # x, dt, A, B, C, D, h0
        vp, vp,                      # y, h_out
        ci, ci, ci, ci, ci, ci,      # B, S, H, P, N, chunk
        cl, cl, cl, cl, cl, cl,      # strides (batch, position, head) of x, dt
        cl, cl, cl, cl, cl, cl,      # ... and of B, C
        ci, ci, vp]                  # is_bf16, design, stream
    lib.repro_grouped_gemm.restype = ci
    lib.repro_grouped_gemm.argtypes = [
        vp, vp, vp, vp,              # x, w, group_sizes, out
        vp, vp, ci,                  # partial sums, info, max_split
        ci, ci, ci, ci,              # C, K, N, E
        ci, ci, vp]                  # is_bf16, SM count, stream
    lib.repro_grouped_swiglu.restype = ci
    lib.repro_grouped_swiglu.argtypes = [
        vp, vp, vp, vp, vp,          # x, w_gate, w_up, group_sizes, out
        vp, vp, ci,                  # partial sums, info, max_split
        ci, ci, ci, ci,              # C, K, N, E
        ci, ci, vp]                  # is_bf16, SM count, stream
    lib.repro_add_rms_norm.restype = ci
    lib.repro_add_rms_norm.argtypes = [
        vp, vp, vp, vp, vp,          # x, delta, weight, x_out, h_out
        ci, ci, cf,                  # rows, d, eps
        ci, vp]                      # is_bf16, stream
    lib.repro_rope_kv_write.restype = ci
    lib.repro_rope_kv_write.argtypes = [
        vp, vp, vp, vp, vp,          # q, k, v, cos, sin
        vp, vp, vp, vp,              # k_cache, v_cache, lens, q_out
        ci, ci, ci, ci, ci,          # B, Hq, Hkv, D, Smax
        ci, vp]                      # is_bf16, stream
    lib.repro_silu_mul.restype = ci
    lib.repro_silu_mul.argtypes = [
        vp, vp, vp, cl,              # g, u, out, n
        ci, vp]                      # is_bf16, stream
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ci]


def load(verbose_ptxas: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built first if need be). The process's
    first load, its build included, is the span ``backend.kernels.load``,
    most often a child of the first decode step's warm-up."""
    global _lib
    with _lock:
        if _lib is None:
            with trace.Span("backend.kernels.load"):
                lib = ctypes.CDLL(str(build(verbose_ptxas)))
                _declare(lib)
            _lib = lib
        return _lib


def on_device(device):
    """Context in which ``device`` is the current CUDA device (a launch goes
    to a stream of the current device); free when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs and a later synchronize does not report it)."""
    if code == 0:
        return
    if code < 0:
        raise RuntimeError(f"{what}: configuration not taken by the kernel "
                           f"(launcher returned {code})")
    msg = lib.repro_cuda_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would have to pass through a kernel. The kernels
    fill their outputs through ``ctypes`` and have no backward (nor do the
    TPU kernels they replace), so the result would carry no ``grad_fn`` and
    a loss would silently get no gradient. Checked before the device
    branch, so a CPU tensor is refused as a CUDA one is; never a quiet
    switch to the plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel has no "
            "backward; train on the plain forms with "
            "RunConfig(attn_impl=\"plain\")")
