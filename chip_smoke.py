#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`griduniverse_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels K1, K2 and K3 from `griduniverse_tpu_torch/
csrc/`, holds each against its plain PyTorch version, drives the port's main
path at full size (level → pack → K1/K2 rollouts; K3 mazes → pack → K1) and
checks what comes out: the main path's own outputs are held bit for bit
against the plain versions on the same inputs. Every phase raises on
failure. The last two lines are a JSON record of the kernels and
`{"ok": true, "device": {...}}`.

It imports nothing of JAX: the reference's per-env golden mazes are read from
`tests/golden/torch/`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAX_EPISODE_STEPS = 512


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _same(name: str, a, b) -> float:
    """Bit-exact equality (floats compared by their bits); returns max|a-b|."""
    _require(a.shape == b.shape and a.dtype == b.dtype, f"{name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.dtype == torch.float32:
        equal = bool((a.view(torch.int32) == b.view(torch.int32)).all())
    else:
        equal = bool((a == b).all())
    err = _max_err(a, b)
    _require(equal, f"{name}: kernel and plain version differ (max abs err {err})")
    return err


def _cuda_ms(fn, reps: int):
    """Mean ms of `reps` calls after a warm-up, and the last call's output."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


_STATE_FIELDS = ("agent_idx", "agent_code", "t", "done")


def _same_scan(tag: str, got, ref) -> float:
    """K1's final state and per-env n_eps, ret_sum, len_sum, bit-exact."""
    for f in _STATE_FIELDS:
        _same(f"{tag} {f}", getattr(got[0], f), getattr(ref[0], f))
    return max(_same(f"{tag} {name}", a, b) for name, a, b in zip(("n_eps", "ret_sum", "len_sum"), got[1:], ref[1:]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this runs only on a GPU")
    sys.path.insert(0, str(ROOT))
    import griduniverse_tpu_torch as gt

    if Path(gt.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: imported the port from {gt.__file__}, not from {ROOT}")
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.core import semantics as S
    from griduniverse_tpu_torch.kernels import build
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    dev = torch.device("cuda", 0)

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path().relative_to(ROOT)}")
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    sem = gt.make_semantics(device=dev)
    walls16 = builders.walls_and_goal_16x16(device=dev)
    bl_walls = bp.pack_level(walls16)
    gen = torch.Generator(device=dev).manual_seed(2026)
    errs = {"random_scan_bits": 0.0, "rollout_actions_bits": 0.0, "aldous_broder_mazes": 0.0}

    def per_env_mazes(seed: int, b: int, cells=(4, 4)):
        grids, start = M.generate_mazes_device(seed, cells, b, "aldous_broder", device=dev)
        return gt.Level(grid=grids, start_idx=start.expand(b).contiguous())

    # -- phase 3: each kernel against its plain version ----------------------
    mazes4k = bp.pack_level(per_env_mazes(11, 4096))
    for lname, bl in (("walls16", bl_walls), ("mazes4k", mazes4k)):
        actions = torch.randint(0, 4, (512, 4096), generator=gen, device=dev, dtype=torch.int32)
        for auto_reset, max_ep in ((False, None), (True, None), (True, 64)):
            st = bp.reset_bits(bl, None if bl.batched else 4096)
            got = bp.rollout_actions_bits(sem, bl, st, actions, auto_reset, max_ep)
            ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, auto_reset, max_ep)
            tag = f"K2 {lname} auto_reset={auto_reset} max_ep={max_ep}"
            for f in _STATE_FIELDS:
                _same(f"{tag} {f}", getattr(got[0], f), getattr(ref[0], f))
            for k, (a, b) in enumerate(zip(got[1], ref[1])):
                errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"{tag} out{k}", a, b))
            print(f"{tag}: bit-exact vs plain (B=4096, T=512)")

    for lname, bl in (("walls16", bl_walls), ("mazes4k", mazes4k)):
        st = bp.reset_bits(bl, None if bl.batched else 4096)
        rs = bp.xorshift_init(5, (4096,), device=dev)
        got = bp.random_scan_bits(sem, bl, st, rs, None, 2000, MAX_EPISODE_STEPS)
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 2000, MAX_EPISODE_STEPS)
        errs["random_scan_bits"] = max(errs["random_scan_bits"], _same_scan(f"K1 {lname}", got, ref))
        print(f"K1 {lname}: final state, n_eps, ret_sum, len_sum bit-exact vs plain "
              f"(B=4096, T=2000, max_episode_steps={MAX_EPISODE_STEPS}); episodes {int(got[1].sum())}")

    for cells, b, max_iters in (((4, 4), 512, None), ((5, 5), 512, 20)):
        mi = max_iters if max_iters is not None else M._ab_default_max_iters(cells[0] * cells[1])
        dirs = torch.randint(0, 4, (mi, b), generator=gen, device=dev, dtype=torch.int8)
        got = M._aldous_broder_mazes(cells, b, mi, directions=dirs)
        ref = M.aldous_broder_mazes_reference(cells, b, mi, directions=dirs)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 injected {cells}", got, ref))
        perfect = all(M.check_perfect_maze(g, cells) for g in got.cpu().numpy())
        _require(perfect, f"K3 injected {cells}: a maze is not perfect")
        print(f"K3 injected cells={cells} B={b} max_iters={mi}: bit-exact vs plain, all perfect")
    got = M._aldous_broder_mazes((6, 6), 512, seed=99, device=dev)
    ref = M.aldous_broder_mazes_reference((6, 6), 512, seed=99, device=dev)
    errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same("K3 seeded (6,6)", got, ref))
    print("K3 seeded cells=(6, 6) B=512: bit-exact vs plain")

    # -- phase 4: the main path, counted -------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launches()

    golden = ROOT / "tests" / "golden"
    cfg4 = np.load(golden / "torch" / "cfg4_mazes_grids.npz")
    golden_levels = {
        "cfg1_empty8": (builders.empty_level(8, 8, goal=True, device=dev), 2),
        "cfg2_walls16": (walls16, 3),
        "cfg3_lava": (builders.lava_level(device=dev), 3),
        "cfg4_mazes": (gt.make_level(cfg4["grids"], cfg4["start_idx"], device=dev), 4),
    }
    replays = []  # (name, level, start state, actions, kernel output) of each golden run
    for name, (level, b) in golden_levels.items():
        g = np.load(golden / f"{name}.npz")
        bl = bp.pack_level(level)
        st = bp.reset_bits(bl, None if bl.batched else b)
        actions = torch.as_tensor(g["actions"], device=dev)
        got = bp.rollout_actions_bits(sem, bl, st, actions, True, 64)
        obs, reward, done = got[1]
        _require(np.array_equal(obs.cpu().numpy(), g["obs"]), f"{name}: obs differ from golden")
        _require(np.array_equal(reward.cpu().numpy().view(np.int32), g["reward"].view(np.int32)),
                 f"{name}: reward differs from golden")
        _require(np.array_equal(done.cpu().numpy(), g["done"]), f"{name}: done differs from golden")
        replays.append((name, bl, st, actions, got))
        print(f"K2 golden {name}: bit-exact ({tuple(actions.shape)} actions)")

    rollouts = []  # (name, level, B, T, final state, stats) of each main-path rollout

    def run_rollout(name, bl, b, steps):
        fn = bp.compile_rollout_random(sem, bl, b, steps, max_episode_steps=MAX_EPISODE_STEPS)
        fn(1)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, stats = fn(7)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        eps, ret, length = int(stats["episodes"]), float(stats["mean_return"]), float(stats["mean_length"])
        _require(eps > 0 and np.isfinite(ret) and 1.0 <= length <= MAX_EPISODE_STEPS,
                 f"{name}: implausible stats {stats}")
        _require(state.agent_idx.shape == (b,) and bool((state.t < MAX_EPISODE_STEPS).all()),
                 f"{name}: bad final state")
        rate = b * steps / (ms / 1e3)
        print(f"K1 main {name}: B={b} T={steps} episodes={eps} mean_return={ret!r} "
              f"mean_length={length!r} time={ms!r} ms steps/s={rate!r}")
        rollouts.append((name, bl, b, steps, state, stats))

    run_rollout("walls16", bl_walls, 65_536, 10_000)
    bl_lava = bp.pack_level(builders.lava_level(device=dev))
    run_rollout("lava", bl_lava, 16_384, 10_000)
    run_rollout("empty8", bp.pack_level(builders.empty_level(8, 8, goal=True, device=dev)), 1, 10_000)

    b64 = 65_536
    mazes = per_env_mazes(2026, b64)
    n_open = (mazes.grid != S.WALL).sum(dim=(1, 2))
    _require(bool((n_open == 2 * 16 - 1).all()), "K3 seeded: a maze has the wrong number of open tiles")
    _require(bool((mazes.grid[:, 7, 7] == S.GOAL).all()), "K3 seeded: goal missing")
    sample = mazes.grid[:1024].cpu().numpy()
    _require(all(M.check_perfect_maze(g, (4, 4)) for g in sample), "K3 seeded: a maze is not perfect")
    print(f"K3 seeded cells=(4, 4) B={b64}: every maze has {2 * 16 - 1} open tiles; 1024 checked perfect")

    b2 = 4096
    g2, _ = M.generate_mazes_device(8, (2, 2), b2, "aldous_broder", device=dev)
    walls = torch.stack([g2[:, 2, 1], g2[:, 2, 3], g2[:, 1, 2], g2[:, 3, 2]], dim=1)
    open_mask = (walls != S.WALL).cpu().numpy()
    _require(bool((open_mask.sum(axis=1) == 3).all()), "K3 2x2: not a spanning tree")
    counts = np.bincount(np.argmin(open_mask, axis=1), minlength=4)
    sigma = np.sqrt(b2 * 0.25 * 0.75)
    _require(bool(np.all(np.abs(counts - b2 / 4) < 5 * sigma)), f"K3 2x2: not uniform {counts}")
    print(f"K3 seeded 2x2 spanning-tree counts {counts.tolist()} (expect {b2 // 4} ± {5 * sigma:.0f})")

    bl_mazes = bp.pack_level(mazes)
    run_rollout("mazes64k", bl_mazes, b64, 5_000)

    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the main path: {launches}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # -- phase 5: the main path's outputs against the plain versions ----------
    for name, bl, st, actions, got in replays:
        ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, True, 64)
        for f in _STATE_FIELDS:
            _same(f"K2 main {name} {f}", getattr(got[0], f), getattr(ref[0], f))
        for k, (a, b) in enumerate(zip(got[1], ref[1])):
            errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"K2 main {name} out{k}", a, b))
        print(f"K2 main {name}: final state and outputs bit-exact vs plain")

    for name, bl, b, steps, state, stats in rollouts:
        st = bp.reset_bits(bl, None if bl.batched else b)
        rs = bp.xorshift_init(7, (b,), device=dev)
        ref_state, n, r, length = bp.random_scan_bits_reference(sem, bl, st, rs, steps, MAX_EPISODE_STEPS)
        for f in _STATE_FIELDS:
            _same(f"K1 main {name} {f}", getattr(state, f), getattr(ref_state, f))
        denom = n.sum().clamp(min=1)
        _same(f"K1 main {name} episodes", stats["episodes"], n.sum())
        _same(f"K1 main {name} mean_return", stats["mean_return"], r.sum() / denom)
        _same(f"K1 main {name} mean_length", stats["mean_length"], length.sum() / denom)
        print(f"K1 main {name}: final state and stats bit-exact vs plain (B={b}, T={steps})")

    for cells, b, seed, grids in (((4, 4), b64, 2026, mazes.grid), ((2, 2), b2, 8, g2)):
        ref = M.aldous_broder_mazes_reference(cells, b, seed=seed, device=dev)
        errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same(f"K3 main {cells}", grids, ref))
        print(f"K3 main seeded cells={cells} B={b}: grids bit-exact vs plain")

    # -- phase 6: kernel and plain-version times, outputs compared ------------
    times = {}
    for name, bl, b in (("walls16", bl_walls, b64), ("lava", bl_lava, 16_384), ("mazes64k", bl_mazes, b64)):
        st = bp.reset_bits(bl, None if bl.batched else b)
        rs = bp.xorshift_init(3, (b,), device=dev)
        ms, got = _cuda_ms(lambda: bp.random_scan_bits(sem, bl, st, rs, None, 1000, MAX_EPISODE_STEPS), 5)
        plain_ms, ref = _cuda_ms(lambda: bp.random_scan_bits_reference(sem, bl, st, rs, 1000, MAX_EPISODE_STEPS), 1)
        errs["random_scan_bits"] = max(errs["random_scan_bits"], _same_scan(f"K1 timed {name}", got, ref))
        print(f"K1 timed {name} B={b} T=1000: per-env state and accumulators bit-exact vs plain")
        if name == "walls16":
            times["random_scan_bits"] = (ms, plain_ms, f"walls16 B={b} T=1000")
    st = bp.reset_bits(bl_walls, 4096)
    actions = torch.randint(0, 4, (512, 4096), generator=gen, device=dev, dtype=torch.int32)
    ms, got = _cuda_ms(lambda: bp.rollout_actions_bits(sem, bl_walls, st, actions, True, 64), 10)
    plain_ms, ref = _cuda_ms(lambda: bp.rollout_actions_bits_reference(sem, bl_walls, st, actions, True, 64), 2)
    for f in _STATE_FIELDS:
        _same(f"K2 timed {f}", getattr(got[0], f), getattr(ref[0], f))
    for k, (a, b) in enumerate(zip(got[1], ref[1])):
        errs["rollout_actions_bits"] = max(errs["rollout_actions_bits"], _same(f"K2 timed out{k}", a, b))
    times["rollout_actions_bits"] = (ms, plain_ms, "walls16 B=4096 T=512 auto-reset max_ep=64")
    ms, got = _cuda_ms(lambda: M._aldous_broder_mazes((4, 4), b64, seed=5, device=dev), 5)
    plain_ms, ref = _cuda_ms(lambda: M.aldous_broder_mazes_reference((4, 4), b64, seed=5, device=dev), 1)
    errs["aldous_broder_mazes"] = max(errs["aldous_broder_mazes"], _same("K3 timed (4, 4)", got, ref))
    times["aldous_broder_mazes"] = (ms, plain_ms, f"seeded cells=(4, 4) B={b64}")
    for name, (ms, plain_ms, shape) in times.items():
        print(f"time {name} at {shape}: kernel {ms!r} ms, plain {plain_ms!r} ms, outputs bit-exact ({smi})")

    sources = {
        "random_scan_bits": ("griduniverse_tpu_torch/csrc/rollout.cu", "griduniverse_tpu/ops/bitplane.py:334"),
        "rollout_actions_bits": ("griduniverse_tpu_torch/csrc/rollout.cu", "griduniverse_tpu/ops/bitplane.py:278"),
        "aldous_broder_mazes": ("griduniverse_tpu_torch/csrc/maze.cu", "griduniverse_tpu/levels/maze.py:331"),
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
