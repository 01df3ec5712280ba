"""Build and bind the hand-written CUDA kernels of `csrc/`.

The sources have a plain C interface, so they are compiled by `nvcc` alone
into one shared library and bound with `ctypes`; nothing includes PyTorch's
headers. The library is built at first use, for `sm_90a`, into `_build/`
beside this file, under a name keyed by a hash of the sources and flags,
so a changed source is rebuilt and an unchanged one is loaded as is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("rollout.cu", "maze.cu")
HEADERS = ("step.cuh",)
# No --use_fast_math: the rollout accumulators must stay bit-exact.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point, in the order of its parameters
_SIGNATURES = {
    "gu_random_scan_bits": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I,
                            _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P],
    "gu_rollout_actions_bits": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I,
                                _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P],
    "gu_aldous_broder_mazes": [_I, _I, _I, _I, _P, _I, _P, _P],
}
_ERROR_STRING = "gu_error_string"  # const char* (int): cudaGetErrorString

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # the compiler's output of the build this process made


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "need the CUDA toolkit to build"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libgu_kernels_{_source_hash()}.so"


def _compile(out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp)]
    cmd += [str(CSRC_DIR / s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """Build the library if needed, load it, and declare its C functions."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            build_log = _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, _ERROR_STRING)
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point `name` on `device`'s current stream (the
    stream is appended to `args`); raise if the launch was refused."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = getattr(lib, _ERROR_STRING)(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code} ({msg})")


def check_int(name: str, value: int, low: int = 0) -> int:
    """Raise unless `low <= value < 2^31` (a C int the kernel takes)."""
    value = int(value)
    if not low <= value < 1 << 31:
        raise ValueError(f"{name} must be in [{low}, 2^31), got {value}")
    return value


def check_tensor(name: str, x, dtype: torch.dtype, shape, device: torch.device) -> int:
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` on
    `device`; return its data pointer."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()
