"""Build and bind the hand-written CUDA kernels of ``aniportrait_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` for ``sm_90a`` to an object, all
sources at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build runs at first use, into
``build/kernels/`` under the repository root, keyed by a hash of the sources
and flags: a changed source gets a new library, an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# --split-compile=0 runs the optimiser over a source's kernel instantiations
# on all cores (flash_attn.cu holds 160 of them): 39.3 s for the whole build
# on the card's 8-core machine against 85.0 s without it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--ptxas-options=-v", "--split-compile=0",
)

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dtype, q, k, v, kb, vb, drop, o, lse, batch, sq, skv, sbank, heads, d,
    # rep, kv_split, scale, stream
    "aniportrait_flash_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # dtype, q, k, v, do, lse, delta, drop, dq, dk, dv, dq_ws, batch, sq, skv,
    # heads, d, kv_split, scale, stream
    "aniportrait_flash_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # dtype, q, k, v, o, batch, frames, s, heads, d, base-2 scale, stream
    "aniportrait_temporal_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 ctypes.c_float, _P],
    # dtype, q, k, v, o, n, seq, heads, d, scale, stream
    "aniportrait_ctg_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    # dtype, mode, q, qs, k, v, bound, o, guard, batch, sq, skv, heads, d,
    # scale, q_scale, stream
    "aniportrait_tok_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, ctypes.c_float, ctypes.c_float, _P],
    # dtype, q, k, v, o, n, t, seq, d, n_valid, stream
    "aniportrait_ssa_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    cuda_bin = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    nvcc = shutil.which("nvcc") or shutil.which("nvcc", path=str(cuda_bin))
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of aniportrait_tpu_torch build "
            "only where the CUDA toolkit is installed"
        )
    return nvcc


def build() -> Path:
    """Compile the kernels if no library for the current sources exists;
    return the library's path.  The compiler's report (registers, shared
    memory, spills per kernel) is kept beside it as ``build.log``."""
    tag = source_hash()
    lib = BUILD_DIR / f"libaniportrait_kernels_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    stem = f"{tag}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        report.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out[-4000:])
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        report.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr[-4000:])
    (BUILD_DIR / "build.log").write_text("\n".join(report))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp.replace(lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError_t {err} "
            f"({torch.cuda.get_device_name()})"
        )


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
