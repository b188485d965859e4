"""Builds the port's CUDA kernels and launches them.

``csrc/*.cu`` are compiled with nvcc for ``sm_90a`` at first use, each
source to an object file in parallel, then linked into one shared library
with a plain C interface under ``build/repro_torch/`` (named by a hash of
the sources and flags, so a later process reuses it). The library is
loaded with ctypes; every pointer and the stream go as ``c_void_p``.
Any failure raises: there is no fallback.

``launches`` counts the launches of each kernel and ``work`` the keys,
entries, query rows, sequences, (token, head) rows, op rows, window ops or
moved slots handed to it;
``launch`` is the only place that adds to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
# C entry point -> argument types; each returns cudaGetLastError()
SIGNATURES = {
    "clht_probe_launch": (_P, _I, _P, _P, _I, _P, _P, _P),
    "kvs_lookup_fused_launch": (_P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                                _P),
    "log_merge_sorted_launch": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                _P),
    "clht_insert_prepare": (_P, _P, _I, _I, _P, _P),
    "clht_insert_mark": (_P, _P, _P, _I, *(_P,) * 8),
    "clht_insert_plan": (_P, _I, _P, _P, _P, _P, _I, *(_P,) * 5),
    "clht_insert_launch": (_P, _I, _I, _P, _P, _P, _P, _I, *(_P,) * 12),
    "flash_attention_launch": (_I, _P, _P, _P, _P, *(_I,) * 18, _F, _I, _I,
                               _P),
    "paged_decode_attention_launch": (_I, _I, _P, _I, *(_P,) * 5,
                                      *(_I,) * 9, _F, *(_P,) * 6),
    "ssd_scan_launch": (_I, *(_P,) * 7, *(_I,) * 13, _P),
    "cache_transition_launch": (_P, _I, _P, *(_I,) * 4, _P, _P, _P, _P),
    "fused_window_build": (_P, _P, _P, _I, _P, _P, _P),
    "fused_windows_launch": (_P, _I, _P),
    "fused_window_gather": (*(_P,) * 8, _I, _P, _I, _P, _P),
    "fused_window_scatter": (*(_P,) * 8, _I, _P, _P, _P, _I, _P),
    "fused_window_guards": (*(_P,) * 4, _I, _P, _P),
}
KERNELS = ("clht_probe", "kvs_lookup_fused", "log_merge_sorted",
           "clht_insert", "flash_attention", "paged_decode_attention",
           "ssd_scan", "cache_transition", "fused_window",
           "fused_window_gather", "fused_window_scatter",
           "fused_window_guards")

launches = dict.fromkeys(KERNELS, 0)
work = dict.fromkeys(KERNELS, 0)

_lib: ctypes.CDLL | None = None


def reset_counts() -> None:
    for name in KERNELS:
        launches[name] = 0
        work[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdinomo_kernels-{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> str:
    """Compile every csrc/*.cu in parallel and link them into ``so``;
    returns nvcc's output (ptxas register and spill lines)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode:
                failed.append(f"{obj.stem}.cu:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        part = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for o, _ in jobs),
             "-o", str(part)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(part, so)        # atomic: concurrent builders agree
    return "".join(log)


def build() -> ctypes.CDLL:
    """The loaded kernel library, built first if no process has built
    these sources yet."""
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists():
            log = _compile(so)
            so.with_suffix(".log").write_text(log)
        lib = ctypes.CDLL(str(so))
        for fn, args in SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.dinomo_error_string.argtypes = (ctypes.c_int,)
        lib.dinomo_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def run(fn: str, *args, kernel: str | None = None) -> None:
    """Call C entry point ``fn`` and raise on a launch error; counts
    nothing (a step of a kernel whose launch ``launch`` counts)."""
    lib = build()
    err = getattr(lib, fn)(*args)
    if err:
        msg = lib.dinomo_error_string(err).decode()
        raise RuntimeError(f"{kernel or fn}: CUDA launch failed: {msg} "
                           f"({err})")


def launch(kernel: str, fn: str, items: int, *args) -> None:
    """Call C entry point ``fn`` (launching ``kernel`` on ``items`` keys or
    entries), raise on a launch error, and count the launch."""
    run(fn, *args, kernel=kernel)
    launches[kernel] += 1
    work[kernel] += items


def require(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int,
            align: int = 4) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    rank whose data is ``align``-byte aligned (the kernels take raw
    pointers; bucket lines are read as 16-byte vectors)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected {align}-byte alignment")
