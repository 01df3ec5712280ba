"""Build and bind the hand-written CUDA kernels of `csrc/`.

The sources have a plain C interface, so they are compiled by `nvcc` alone
and bound with `ctypes`; nothing includes PyTorch's headers. At first use
every source is compiled to an object file, one `nvcc` process each, all
started together, and the objects are linked into one shared library for
`sm_90a` in `_build/` beside this file, under a name keyed by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as is.
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
SOURCES = (
    "rollout.cu", "maze.cu", "dp_grid.cu", "td_fast.cu", "td_batched.cu", "segment_mean.cu",
    "gae.cu", "act_step.cu", "embed_rows.cu", "agent_stamp.cu",
    "replay.cu", "backtracker.cu", "gather_probe.cu", "trace_pass.cu",
    "dqn_act.cu", "mc_returns.cu",
)
HEADERS = ("step.cuh", "maze_tree.cuh")
# No --use_fast_math, and -fmad=false: every kernel is held bit for bit
# against a plain PyTorch version that rounds a multiply and an add
# separately, so `a + b*c` must not contract into one fused multiply-add.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SEM = [_P, _P, _P, _P, _I]            # passable, terminal, reward, deltas, A
_LEVEL = [_P, _I, _I, _P, _P, _I, _I]  # words, n_words, per_env, starts, h, w
# argtypes of every C entry point, in the order of its parameters
_SIGNATURES = {
    # ...; state in (3), rs; stream, key (2 words), first step, lane offset; the
    # plan's threads and shared bytes, the draw's form and multiplier; outputs (7)
    "gu_random_scan_bits": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I,
                            _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "gu_rollout_actions_bits": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I,
                                _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P],
    # ch, cw, batch, max_iters (64-bit); dirs; seed; grids; mazes a block, shared
    # bytes, the device tier's scratch (or null)
    "gu_aldous_broder_mazes": [_I, _I, _I, ctypes.c_longlong, _P, _I, _P, _I, _I, _P, _P],
    # grids, n, h, w, policy; v in, out; gamma, sweeps; mazes, threads, cells a
    # thread, table; partial, its rows; maxima, ticket
    "gu_grid_sweeps": _SEM + [_P, _I, _I, _I, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    # grids, n, h, w, policy; v in, out; gamma, sweeps; blocks a cluster, rows
    # a band, cells a thread; partial, its rows; maxima, ticket
    "gu_grid_sweeps_cluster": _SEM + [_P, _I, _I, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    # grids, n, h, w, policy; v; gamma; policy out, changed; mazes, threads,
    # cells a thread; partial, its rows; ticket
    "gu_grid_greedy": _SEM + [_P, _I, _I, _I, _P, _P, _F, _P, _P, _I, _I, _I, _P, _I, _P, _P],
    # grids, n, h, w, policy; v in, out, tmp, info; gamma, sweeps; maxima
    "gu_grid_sweeps_global": _SEM + [_P, _I, _I, _I, _P, _P, _P, _P, _P, _F, _I, _P, _P],
    "gu_grid_greedy_global": _SEM + [_P, _I, _I, _I, _P, _P, _F, _P, _P, _P],
    # batch, steps, max_episode_steps, expected_sarsa; alpha, gamma, eps, 1 - eps;
    # eps16; blocks, envs a thread in registers, envs a thread; q in, out; state
    # in (7), out (7); q_buf, acc, cnt
    "gu_td_scan_fast": _SEM + _LEVEL + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I]
                       + [_P] * 19 + [_P],
    # S·A, envs a thread, A; out (2 ints)
    "gu_td_scan_fast_resident": [_I, _I, _I, _P, _P],
    # the plan (host memory), step, act
    "gu_td_step": [_P, _I, _I, _P],
    # n, steps, max_episode_steps, algo, bf16; alpha, gamma, eps, 1 - eps; eps16,
    # draw_first; threads, blocks, shared bytes; draws (4), q, state (8)
    "gu_td_batched": _SEM + _LEVEL + [_I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I] + [_I] * 3
                     + [_P] * 4 + [_P] * 9 + [_P],
    # q in, out, s, a, delta, mask; alpha; batch, A, S·A, chunk; counts, vals,
    # look-back words; launched
    "gu_segment_mean": [_P] * 6 + [_F] + [_I] * 4 + [_P] * 4 + [_P],
    # sums, counts out, s, a, delta, mask; the rest as gu_segment_mean
    "gu_segment_sums": [_P] * 6 + [_F] + [_I] * 4 + [_P] * 4 + [_P],
    # q in, out (Q or the sums), counts out (or null), s, a, delta, mask; alpha;
    # batch, A, S·A, the cluster's blocks; the scratch (or null)
    "gu_segment_cluster": [_P] * 7 + [_F] + [_I] * 4 + [_P] + [_P],
    # blocks, shared bytes; out: clusters the card holds at once
    "gu_segment_cluster_fits": [_I, _I, _P],
    # S·A; out: a block's shared bytes (64-bit)
    "gu_segment_cluster_bytes": [_I, _P],
    # value, reward, done, bootstrap, adv, targets; T, B; gamma, γλ; envs a thread
    "gu_gae": [_P] * 6 + [_I, _I, _F, _F, _I, _P],
    # reward, done, bootstrap, returns; T, B; gamma; envs a thread
    "gu_nstep_returns": [_P] * 4 + [_I, _I, _F, _I, _P],
    # the plan (host memory), step; logits; state in (3); the slot to write
    "gu_act_step": [_P, _I, _P] + [_P] * 3 + [_I, _P],
    # the plan; logits; state and reached in (5); the slot to write
    "gu_greedy_step": [_P, _P] + [_P] * 5 + [_I, _P],
    "gu_embed_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # grad, obs, partial, dtable; N, chunk, chunks, S, E, dtype, shared bytes
    "gu_embed_rows_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # y_tiles, k, bias, obs, out; Nl, T, t_range, H, W, C, vec, dtype
    "gu_agent_stamp": [_P] * 5 + [_I] * 8 + [_P],
    # grad, out, obs, dy_tiles, dy partials, block partials, dk, dbias; Nl, T, H, W, C,
    # cells, tiles, ranges, t_range, units, units a block, blocks, slices, width, vec, dtype
    "gu_agent_stamp_backward": [_P] * 8 + [_I] * 16 + [_P],
    # prio, noise, size, beta; alpha, cap, n; score, partial, idx, w, scratch; launched
    "gu_per_sample": [_P] * 4 + [_F, _I, _I] + [_P] * 6 + [_P],
    # ring (5), prio; batch (5); at, p_max; B, cap
    "gu_replay_write": [_P] * 13 + [_I, _I, _P],
    # ring (5), idx; n, cap; the five outputs in one buffer (4n words, then n bytes)
    "gu_replay_gather": [_P] * 6 + [_I, _I, _P] + [_P],
    # prio, idx, abs_err; eps, n, cap; p_max in, out; owner; launched
    "gu_prio_refresh": [_P] * 3 + [_F, _I, _I, _P, _P, _P, _P, _P],
    # ch, cw, batch, seed; grids; mazes a block, shared bytes, the device tier's
    # scratch (or null)
    "gu_backtracker_mazes": [_I, _I, _I, _I, _P, _I, _I, _P, _P],
    "gu_gather_1d": [_P, _I, _P, _I, _P, _P],
    "gu_take_along_axis1": [_P, _I, _P, _I, _I, _P, _P],
    # e, s, a, delta, cut, table in, out; γλ, cutoff, α; replacing, A, B, cells,
    # appliers a tile; the plan's partial sums, cell counts and tickets
    "gu_trace_pass": [_P] * 7 + [_F, _F, _F] + [_I] * 5 + [_P] * 3 + [_P],
    # the partial-sums form: e, s, a, delta, cut; γλ, cutoff; replacing, A, B, cells; partial, count
    "gu_trace_partials": [_P] * 5 + [_F, _F] + [_I] * 4 + [_P] * 2 + [_P],
    # partial, count, table in, out; α; cells, chunks
    "gu_trace_apply": [_P] * 4 + [_F, _I, _I, _P],
    # the plan (host memory); q, explore, rand_a, state in (3), run_ret, episodes,
    # ret_sum; the outputs' buffer
    "gu_dqn_act_step": [_P] + [_P] * 9 + [_P] + [_P],
    # the plan and the ring (host memory); the same nine; at, p_max; the outputs' buffer
    "gu_dqn_act_store": [_P, _P] + [_P] * 9 + [_P, _P] + [_P] + [_P],
    # rewards, ids, valid; T, B; gamma; returns, first-visit mask; log2 of the group, tile
    "gu_mc_returns": [_P] * 3 + [_I, _I, _F, _P, _P, _I, _I, _P],
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


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all, raise on the first that
    failed; return their output in the order given."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
    return "".join(outputs)


def _compile(out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{stem}.{Path(s).stem}.o" for s in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(CSRC_DIR / s), "-o", str(o)]
            for s, o in zip(SOURCES, objects)
        ])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, out)
    finally:
        for f in (*objects, tmp):
            f.unlink(missing_ok=True)
    return log


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
    stream is appended to `args`); raise if the launch was refused. The
    launch goes to `device`: where it is not the current device, it is
    made current for the call. The stream's handle is read without
    building the Python stream object that `torch.cuda.current_stream`
    returns, to keep the host's share of a launch short."""
    lib = load()
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        code = getattr(lib, name)(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(device):
            code = getattr(lib, name)(*args, torch._C._cuda_getCurrentRawStream(device.index))
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
