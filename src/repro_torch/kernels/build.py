"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads at once.  ``--fmad=false`` keeps every multiply and add rounded on
its own, as the plain PyTorch versions round them; fast math is off.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only when a CUDA tensor reaches a kernel wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
SOURCES = ("cs_adam_tiled.cu", "cs_adam.cu", "cs_csr.cu", "cs_ema_tiled.cu",
           "cs_query.cu", "cs_update.cu")
HEADERS = ("cs_common.cuh",)
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "--fmad=false",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libcs_kernels.so"

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # M, V, bm, sm, bv, g, n_valid, inv, first_pos, upd, dm, dv, order,
    # starts, buckets, depth_m, width_m, depth_v, width_v, k, d,
    # lr, 1-b1, 1-b2, eps, bc1, bc2, stream
    "cs_adam_tiled_launch": [P] * 15 + [I] * 6 + [F] * 6 + [P],
    # M, V, bm, sm, bv, prev_m, prev_v, g, upd,
    # depth_m, width_m, depth_v, width_v, k, d,
    # lr, 1-b1, 1-b2, eps, bc1, bc2, stream
    "cs_adam_fused_launch": [P] * 9 + [I] * 6 + [F] * 6 + [P],
    # buckets, order, starts, prev, scratch, depth, width, k, stream
    "bucket_csr_launch": [P] * 5 + [I] * 3 + [P],
    # S, b, s, x, mask, order, starts, est, scratch,
    # depth, width, d, k, form, unit_scale, scale, beta-1, slice, parts,
    # stream
    "cs_ema_tiled_launch": [P] * 9 + [I] * 6 + [F] * 2 + [I] * 2 + [P],
    # as cs_ema_tiled_launch with S bf16, then the uint32 rounding seed
    "cs_ema_tiled_bf16_launch": [P] * 9 + [I] * 6 + [F] * 2 + [I] * 2
    + [ctypes.c_uint32, P],
    # S, b, s, out, depth, width, d, k, stream
    "cs_query_launch": [P] * 4 + [I] * 4 + [P],
    # S, order, starts, buckets, s, delta, depth, width, csr_width, d, k,
    # stream
    "cs_update_launch": [P] * 6 + [I] * 5 + [P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or CUDA_HOME)")
    return str(path)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile and link the library if it is missing.  Returns
    ``(path, seconds, log)``; ``log`` holds what ``nvcc`` printed
    (registers and spills from ``-Xptxas -v``)."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp_lib),
                *[str(obj) for _n, obj, _p in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{res.stdout}")
        os.replace(tmp_lib, lib)        # atomic: a reader sees all or none
    return lib, time.perf_counter() - t0, "\n".join(logs)


# what the first ``library()`` call of this process spent
_LOAD: dict = {}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    t0 = time.perf_counter()
    path, nvcc_s, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOAD.update(seconds=time.perf_counter() - t0, nvcc=nvcc_s > 0.0)
    return lib


def load_stats() -> Optional[dict]:
    """``{"seconds", "nvcc"}`` of the library's build or load in this
    process: the seconds the first ``library()`` call took, and whether
    ``nvcc`` ran in it (False: the library was on disk already); None
    before the library is loaded."""
    return dict(_LOAD) if _LOAD else None


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_cuda_inputs(name: str, device: torch.device,
                      cells: torch.dtype = torch.float32, **tensors) -> None:
    """Every given tensor (None skipped) lies on ``device`` and is
    contiguous; the sketch ``S`` holds ``cells``, other float tensors are
    float32 and integer ones int32."""
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = (cells if key == "S" else torch.float32) \
            if t.is_floating_point() else torch.int32
        if t.dtype != want:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected "
                             f"{want}")
