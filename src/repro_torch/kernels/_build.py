"""Build, load and launch the hand-written CUDA kernels (``csrc/kernels.cu``).

The source is compiled at first use with ``nvcc`` alone into a shared library
with a plain C interface (no PyTorch headers, so the build takes seconds), and
loaded with ``ctypes``.  The library lands in ``kernels/build/`` next to the
source, named by a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at import:
the CPU tests import every module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of kernels.cu: name -> argtypes (a launch's stream comes last)
_SIGNATURES = {
    "gf2_bmvm_launch": [_P] * 3 + [_I] * 5 + [_P],
    "minsum_check_launch": [_P, _P] + [_I] * 5 + [_P],
    "particle_histogram_launch": [_P] * 5 + [_I] * 7 + [_P],
    "flash_attention_f32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention_tc_launch": [_P] * 7 + [_I] * 10 + [_P],
    "flash_attention_combine_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "flash_attention_tc_smem_bytes": [_I],
}
INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build of the same source was loaded
    log: str               # nvcc's output (ptxas register/shared-memory report), kept
                           # beside the library so a later load reads it too


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def build_command(out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (once per source version) and load the kernel library."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    elif path.with_suffix(".log").exists():
        log = path.with_suffix(".log").read_text()
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.kernels_error_string.argtypes = [ctypes.c_int]
    cdll.kernels_error_string.restype = ctypes.c_char_p
    return Library(cdll, path, seconds, log)


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise if the
    launch was refused (``cudaGetLastError`` is not ``cudaSuccess``)."""
    lib = library().cdll
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (the launch shapes are sized by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                      device: torch.device | None = None) -> None:
    """Raise on anything the kernels do not take: another device, dtype or
    rank, a non-contiguous layout, or a tensor too large for int sizes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() > INT_MAX:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels take < 2^31")
