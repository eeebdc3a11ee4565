"""Builds the CUDA kernels at first use: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds); `VARIANTS` builds a source a
second time with macros of its own (K1's packed-B mode), as a library of its
own, so that its template variants compile beside the first in parallel. The library's file name
carries a hash of the sources and flags, under `build/quantnet_torch/` at the
root of the checkout (listed in .gitignore). nvcc writes to a temporary name
that `os.replace` moves into place, so a build cut off half way leaves no
partial library and no lock for the next one to wait on. Libraries of several
kernels are built by parallel nvcc processes.

Nothing here runs at import time: the CPU tests import every module, and this
machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "quantnet_torch"
# No --use_fast_math: the fused kernel needs IEEE division and
# round-half-to-even. -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_P, _I64, _C, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# C signature of each library's entry point: (function, argtypes).
SIGNATURES = {
    # int8_gemm(a[M,K] s8, b[N,K] s8, c[M,ldc], M, N, K, ldc, store, cs[N],
    #           rs[M], bias[N], zpw[N], act, out_scale, out_zero_point,
    #           gs[G,N], gzpw[G,N], group, bn, stages, grid, smem, split,
    #           slots, held, held_rows, stream)
    "int8_gemm": (
        "int8_gemm",
        [_P, _P, _P, _I64, _I64, _I64, _I64, _C, _P, _P, _P, _P, _C, _F, _F, _P, _P, _I64,
         *[_C] * 8, _P],
    ),
    # fused_dynamic_gemm(x[M,K] f32 or bf16, w[N,ldw] s8, w_scale[N], bias[N],
    #                    out[M,N] f32, M, N, K, ldw, block_k, x_is_bf16, relu,
    #                    workspace, stream)
    "fused_dynamic_gemm": (
        "fused_dynamic_gemm",
        [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P],
    ),
    # depthwise_conv(x[N,H,W,C] s8, w[3,3,1,C] s8, y[N,Ho,Wo,C], N, H, W, C,
    #                Ho, Wo, stride, pad_top, pad_left, pad_value, store, cs[C],
    #                bias[C], zpw[C], act, out_scale, out_zero_point, band,
    #                strip, chunk, groups, threads, smem_bytes, grid, vec,
    #                stream)
    "depthwise_conv": (
        "depthwise_conv",
        [_P, _P, _P, *[_I64] * 10, _C, _P, _P, _P, _C, _F, _F, *[_I64] * 7, _C, _P],
    ),
    # residual_boundary(out[n] f32, identity[n] s8 or f32, q[n] s8, n,
    #                   int8_identity, id_scale, id_zero_point, out_scale,
    #                   out_zero_point, stream)
    "residual_boundary": (
        "residual_boundary", [_P, _P, _P, _I64, _I64, _F, _F, _F, _F, _P],
    ),
}

# Libraries built from another library's source: name -> (source, nvcc
# defines). The packed-B mode of the int8 GEMM (csrc/int8_gemm.cu,
# QT_PACKED_B) exports the same C entry point from its own library.
VARIANTS = {"int8_gemm_packed": ("int8_gemm", ("-DQT_PACKED_B=1",))}
# Every library: one per source, and the variants.
LIBRARIES = (*SIGNATURES, *VARIANTS)

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def _source(name: str):
    """(the .cu file, the extra nvcc flags) of a library."""
    src, defines = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", defines


def _signature(name: str):
    """(C entry point, argtypes) of a library: its source's."""
    return SIGNATURES[_source(name)[0].stem]


def _library_path(name: str) -> Path:
    source, defines = _source(name)
    h = hashlib.sha256()
    for src in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = LIBRARIES) -> Dict[str, ctypes.CDLL]:
    """Build (where not built yet) and load the named kernels' libraries, all
    nvcc processes started together. Returns {name: library}; raises on a
    failed build."""
    names = [n for n in names if n not in _libs]
    pending = {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        log = tmp.with_name(f"{tmp.name}.log")
        source, defines = _source(name)
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(source)]
        with open(log, "w") as out:
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, log, path, time.perf_counter())
    try:
        # Each library's own build time: the processes are polled together.
        running = dict(pending)
        while running:
            for name, (proc, tmp, log, path, t0) in list(running.items()):
                if proc.poll() is None:
                    if time.perf_counter() - t0 > NVCC_TIMEOUT_S:
                        raise RuntimeError(f"nvcc took more than {NVCC_TIMEOUT_S} s for {name}")
                    continue
                del running[name]
                build_seconds[name] = time.perf_counter() - t0
                build_log[name] = log.read_text()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}:\n{build_log[name]}")
                os.replace(tmp, path)
            time.sleep(0.05)
    finally:
        for proc, tmp, log, _, _ in pending.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in (tmp, log):
                if f.exists():
                    f.unlink()
    for name in names:
        lib = ctypes.CDLL(str(_library_path(name)))
        fn_name, argtypes = _signature(name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return {n: _libs[n] for n in LIBRARIES if n in _libs}


def kernel(name: str):
    """The C entry point of one kernel, building its library at first use."""
    if name not in _libs:
        build([name])
    return getattr(_libs[name], _signature(name)[0])


def function(name: str, fn_name: str, argtypes):
    """Another C entry point of a kernel's library (a query or a test
    kernel beside the main one), typed, building the library at first use."""
    if name not in _libs:
        build([name])
    fn = getattr(_libs[name], fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
