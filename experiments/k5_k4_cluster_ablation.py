"""What holds back K5's one-block sharded step (commit ba0f08b) and where K4's
cluster tier spends its time: each source built with one cost cut or one
change at a time, timed on one CUDA card. A one-off experiment of the
redesign, kept to reproduce its readings; it is not part of the package.

    python -m experiments.k5_k4_cluster_ablation [--old DIR] [--new]

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints the card's name and power limit (`nvidia-smi`), then builds each
variant into a library of its own under `build/k5_k4_cluster_ablation/`.

With `--old DIR` (a tree of commit ba0f08b, whose `csrc/td_fast.cu` has the
sharded step as one block rebuilding all of Q_t, `td_fast_step_kernel`, and
`gu_td_step_sharded`; the cuts replace exact lines of that source), one step
at walls16 with B = 65,536 on fixed rows (Q_1 from a Q and a summed
aggregate, the envs stepped, the aggregate added, the next cleared), in a
CUDA graph of ten (the device's time) and as timed over 200 calls:
- "as built": the kernel as that tree built it, its argument list made once;
- "empty launch": every block returns at once (a launch's floor);
- "without the rebuild": each block stages Q_t as zeros instead of
  rebuilding every entry from L2 with a float64 divide;
- "without the flush": the blocks' shared counters never reach the global
  aggregate (no global atomics);
- "the state loaded first": each env's seven words loaded at the top of the
  kernel, before the rebuild and the barrier;
and on the host, that tree's wrapper's work a call (its semantics and level
arguments built and its twelve tensors checked each call) against the same
launch on an argument list made once, and this tree's `TdStepPlan.step`.

With `--new`, this tree's K5 sharded step through a `TdStepPlan` at every
cluster size that divides its 128 blocks, in a graph of ten, and at
clusters of 8, 2 and 1 with one cost cut at a time (`gu_td_step` of a
patched `csrc/td_fast.cu`, called on the plan): "empty launch" (every block
returns at once), "without the remote atomics" (no warp's increments reach
the owner's counters), "without the stores into other blocks" (each block
stores its slice of Q_t into its own memory only); and this tree's K4
cluster tier (`gu_grid_sweeps_cluster`) at 64 sidewinder mazes of 161×129,
16 VI sweeps a launch, as timed and in a graph, built:
- "as built";
- "one sweep": a launch of one sweep (the words built, V in and out, the
  maxima), the fixed cost of a launch;
- "without the sweep barrier": no cluster barrier between sweeps;
- "cells unrolled by four": the loop over a thread's cells unrolled four
  times (a guard in place of the break), so that four cells' loads are in
  flight at once;
- "half the threads" or "twice the threads" (512 or 1,024 a block), half
  as many or twice as many cells a thread;
- "neighbours loaded first": each action's neighbour read from the band at
  a clamped index before the word decides whether it is used (the band's
  edge alone through distributed shared memory), so that a cell's loads
  are in flight at once;
- "k bands a maze" (k = 3, 4, 6, 8): as built, on more blocks a maze than
  `cluster_plan` picks (thinner bands, more blocks an SM, more edges).
Each is timed in turns (the variants in order, then in reverse). The cut
versions compute wrong values; they are timed, never used.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.kernels.rollout import level_args, semantics_args
from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms
from griduniverse_tpu_torch.tools.profile_turns import _events_ms, _host_us, _plan_graph_ms, _smi

HERE = Path(__file__).resolve().parents[1]
OUT = Path("build/k5_k4_cluster_ablation")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SEM = [_P, _P, _P, _P, _I]
_LEVEL = [_P, _I, _I, _P, _P, _I, _I]
# `gu_td_step_sharded` of commit ba0f08b, the stream last
OLD_STEP_SIGNATURE = _SEM + _LEVEL + [_I, _I, _I, _F, _F, _F, _F, _I, _I, _I] + [_P] * 5 + [_P] * 7 + [_P]

_OLD_STAGE = "      s_q[i] = rebuilt(apply_prev, g.q_in, acc_prev, cnt_prev, i);"
_OLD_FLUSH = "      if (c != 0) {\n        atomicAdd(acc_cur + i, s_acc[i]);"
_OLD_TOP = "  const int gstride = gridDim.x * kThreads;\n  const int apply_prev = sa.agg_prev != nullptr;"
_OLD_LOAD = "  if (gtid < g.batch) {\n    Env e = load_env(g, gtid, false);"
OLD_CUTS = {
    "as built": {},
    "empty launch": {_OLD_TOP: "  if (sa.act >= 0) return;\n" + _OLD_TOP},
    "without the rebuild": {_OLD_STAGE: "      s_q[i] = 0.0f;"},
    "without the flush": {_OLD_FLUSH: "      if (c == -1) {\n        atomicAdd(acc_cur + i, s_acc[i]);"},
    "the state loaded first": {
        _OLD_TOP: _OLD_TOP + "\n  Env e_first{};\n  if (gtid < g.batch) e_first = load_env(g, gtid, false);",
        _OLD_LOAD: "  if (gtid < g.batch) {\n    Env e = e_first;"},
}

_SWEEP_SYNC = "        cluster.sync();  // the sweep's V_new complete in every band; the old buffers free"
_CELLS_LOOP = ("        for (int c = 0; c < cells; ++c) {\n          const int l = t + c * kClusterThreads;\n"
               "          if (l >= mine) break;\n          const int s = first + l;\n          const uint32_t word")
_THREADS = "constexpr int kClusterThreads = "
_V_OF = ("                const float v = kind == kMove ? v_of(cluster, v_old, s + off[i], first, mine, band) : "
         "v_old[l];")
_V_FIRST = ("                const int ln = l + off[i];\n"
            "                float v = v_old[min(max(ln, 0), mine - 1)];\n"
            "                if (kind != kMove) {\n"
            "                  v = v_old[l];\n"
            "                } else if (static_cast<unsigned>(ln) >= static_cast<unsigned>(mine)) {\n"
            "                  v = v_of(cluster, v_old, s + off[i], first, mine, band);\n"
            "                }")


def _threads(n: int) -> dict[str, str]:
    """The patch that sets kClusterThreads to `n` (a no-op where it is)."""
    import re

    built = int(re.search(r"constexpr int kClusterThreads = (\d+);", (HERE / "griduniverse_tpu_torch/csrc/dp_grid.cu")
                          .read_text()).group(1))
    return {} if n == built else {f"{_THREADS}{built};": f"{_THREADS}{n};"}


def _k4_variants() -> dict[str, tuple[dict[str, str], int, int]]:
    text = (HERE / "griduniverse_tpu_torch/csrc/dp_grid.cu").read_text()
    built = 1024 if f"{_THREADS}1024;" in text else 512
    other = 512 if built == 1024 else 1024
    variants = {
        "as built": ({}, built, 16),
        "one sweep": ({}, built, 1),
        "without the sweep barrier": ({_SWEEP_SYNC: ""}, built, 16),
        "cells unrolled by four": ({_CELLS_LOOP: _CELLS_LOOP.replace("        for (int c", "#pragma unroll 4\n        for (int c")
                                    .replace("if (l >= mine) break;", "if (l >= mine) continue;")}, built, 16),
        ("half the threads" if other < built else "twice the threads"): (_threads(other), other, 16),
    }
    if _V_OF in text:
        variants["neighbours loaded first"] = ({_V_OF: _V_FIRST}, built, 16)
        variants["neighbours loaded first, " + ("half" if other < built else "twice") + " the threads"] = (
            {_V_OF: _V_FIRST, **_threads(other)}, other, 16)
    return variants


_K5_TOP = ("__global__ void __launch_bounds__(kThreads) td_step_cluster_kernel(TdStepPlan p, int step) {\n"
           "  const cg::cluster_group cluster = cg::this_cluster();")
_K5_REMOTE_ADDS = ("    atomicAdd(cluster.map_shared_rank(s_acc + at, owner), sum);\n"
                   "    atomicAdd(cluster.map_shared_rank(s_cnt + at, owner), __popc(peers));")
_K5_REMOTE_STORES = "    for (int b = 0; b < blocks; ++b) *cluster.map_shared_rank(s_q + lo + i, b) = q;"
K5_CUTS = {
    "as built": {},
    "empty launch": {_K5_TOP: _K5_TOP + "\n  if (step >= 0) return;"},
    # the sum is still computed: a store that never happens keeps it
    "without the remote atomics": {_K5_REMOTE_ADDS: "    if (sum == 0x7fffffffffffffffull) s_cnt[at] = owner;"},
    "without the stores into other blocks": {_K5_REMOTE_STORES: "    s_q[lo + i] = q;"},
}


def _libraries(specs: list[tuple[Path, Path, dict[str, str]]]) -> list[ctypes.CDLL]:
    """Each (src, out_dir, patches): `src` with each key of `patches` replaced
    by its value, built into a library of its own; every nvcc started at
    once."""
    jobs = []
    for src, out_dir, patches in specs:
        text = src.read_text()
        for old, new in patches.items():
            if old not in text:
                raise SystemExit(f"k5_k4_cluster_ablation: {src} has no `{old}`")
            text = text.replace(old, new)
        out_dir.mkdir(parents=True, exist_ok=True)
        cu, lib = out_dir / src.name, out_dir / f"lib{src.stem}.so"
        cu.write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-shared", "-o", str(lib), str(cu)]
        jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib))
    for proc, lib in jobs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k5_k4_cluster_ablation: nvcc failed for {lib}:\n{out}")
    return [ctypes.CDLL(str(lib)) for _, lib in jobs]


def _entry(lib: ctypes.CDLL, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(name: str, code: int) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def _stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _in_turns(calls: dict, measure) -> dict:
    times: dict[str, list] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times.setdefault(name, []).append(measure(calls[name]))
    return times


def _k5_inputs(gt, dev):
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem = gt.make_semantics(device=dev)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    ts = td_fast.fast_td_init(sem, bl, 7, 65_536)
    n = ts.q.numel()

    def rows():
        """A state, Q_0, Q_1 and three aggregate rows, the summed one random."""
        state = [x.clone() for x in (ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs,
                                     ts.run_ret, ts.n_eps_env, ts.ret_sum_env)]
        g = torch.Generator(device=dev).manual_seed(1)
        agg = torch.zeros((3, 2, n), dtype=torch.int64, device=dev)
        agg[0, 0] = torch.randint(-2**36, 2**36, (n,), generator=g, device=dev)
        agg[0, 1] = torch.randint(0, 64, (n,), generator=g, device=dev)
        return state, ts.q.clone(), torch.empty_like(ts.q), agg

    return sem, bl, ts, rows


def ablate_old_k5(old: Path, gt, dev, smi) -> None:
    sem, bl, ts, rows = _k5_inputs(gt, dev)
    b = 65_536
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
    args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
    consts = [b, 512, 0, 0.1, 0.99, 0.1, 0.9, int(0.1 * 65536.0), 1, b // 512]
    state, q_prev, q_cur, agg = rows()
    ptrs = [q_prev.data_ptr(), q_cur.data_ptr(), agg[0].data_ptr(), agg[1].data_ptr(), agg[2].data_ptr(),
            *[x.data_ptr() for x in state]]
    libs = _libraries([(old / "griduniverse_tpu_torch/csrc/td_fast.cu", OUT / f"old_k5_{i}", patches)
                       for i, patches in enumerate(OLD_CUTS.values())])
    fns = {name: _entry(lib, "gu_td_step_sharded", OLD_STEP_SIGNATURE) for name, lib in zip(OLD_CUTS, libs)}
    calls = {name: (lambda fn=fn: _checked("gu_td_step_sharded", fn(*args, *consts, *ptrs, _stream())))
             for name, fn in fns.items()}
    times = _in_turns(calls, lambda fn: (_graph_ms(fn), _events_ms(fn, reps=200)))
    for name, pairs in times.items():
        print(f"[ablation] the old K5 sharded step walls16 B={b}, {name}: {[p[0] * 1e3 for p in pairs]!r} us in a "
              f"CUDA graph of ten, {[p[1] * 1e3 for p in pairs]!r} us as timed ({smi})")

    from griduniverse_tpu_torch.kernels import td_fast as k5

    as_built = fns["as built"]
    table, agg_shape = (bl.num_states, sem.num_actions), (2, bl.num_states * sem.num_actions)

    def old_wrapper():
        # that tree's `td_step_sharded_cuda`: the arguments built and twelve tensors checked a call
        a = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
        a += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
        p = [build.check_tensor("q_prev", q_prev, torch.float32, table, dev),
             build.check_tensor("q_cur", q_cur, torch.float32, table, dev)]
        p += [build.check_tensor(f"agg{k}", agg[k], torch.int64, agg_shape, dev) for k in range(3)]
        p += [build.check_tensor(name, x, x.dtype, (b,), dev) for name, x in zip(k5.STATE_FIELDS, state)]
        _checked("gu_td_step_sharded", as_built(*a, *consts, *p, _stream()))

    plan = k5.TdStepPlan(sem, bl, q_prev, state, 0.1, 0.99, 0.1, 0, 512, q_rows=(q_prev, q_cur),
                         aggregates=tuple(agg.unbind(0)), q_final=q_cur)
    host = {"that tree's wrapper (arguments built, twelve checks a call)": old_wrapper,
            "the same launch on an argument list made once": calls["as built"],
            "this tree's TdStepPlan.step": lambda: plan.step(1)}
    for name, us in _in_turns(host, lambda fn: _host_us(fn, calls=500)).items():
        print(f"[ablation] K5 sharded step on the host, {name}: {us!r} us a call ({smi})")


def ablate_new(gt, dev, smi) -> None:
    from griduniverse_tpu_torch.kernels import dp_grid
    from griduniverse_tpu_torch.kernels import td_fast as k5
    from griduniverse_tpu_torch.levels import maze as M

    sem, bl, ts, rows = _k5_inputs(gt, dev)

    def make(cluster):
        state, q_prev, q_cur, agg = rows()
        return k5.TdStepPlan(sem, bl, q_prev, state, 0.1, 0.99, 0.1, 0, 512, q_rows=(q_prev, q_cur),
                             aggregates=tuple(agg.unbind(0)), q_final=q_cur, cluster=cluster)

    calls = {cluster: cluster for cluster in (8, 4, 2, 1)}
    times = _in_turns(calls, lambda c: _plan_graph_ms(lambda: make(c), lambda plan: plan.step(1)))
    for cluster, ms in times.items():
        print(f"[ablation] this tree's K5 sharded step walls16 B=65536, clusters of {cluster}: "
              f"{[x * 1e3 for x in ms]!r} us in a CUDA graph of ten ({smi})")
    # the same at larger tables: nine actions on walls16 (2,304 entries) and a 45x45 maze (2,025
    # states, 8,100 entries, the staged form's largest kind), and at 4,096 envs (8 blocks)
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.core.semantics import SemanticsConfig
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    king = ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0))
    sem9 = gt.make_semantics(SemanticsConfig(action_deltas=king), device=dev)
    g45, s45 = M.generate_mazes_device(5, (22, 22), 1, device=dev)
    bl45 = bp.pack_level(gt.Level(grid=g45[0].contiguous(), start_idx=s45))
    for tag, sem_k, bl_k, b_k in (("walls16 nine actions", sem9, bl, 65_536), ("45x45 maze", sem, bl45, 65_536),
                                  ("walls16 B=4096", sem, bl, 4_096)):
        ts_k = td_fast.fast_td_init(sem_k, bl_k, 7, b_k)

        def make_k(cluster, sem_k=sem_k, bl_k=bl_k, ts_k=ts_k):
            state = [x.clone() for x in (ts_k.env_state.agent_idx, ts_k.env_state.agent_code, ts_k.env_state.t,
                                         ts_k.rs, ts_k.run_ret, ts_k.n_eps_env, ts_k.ret_sum_env)]
            plan = k5.TdStepPlan(sem_k, bl_k, ts_k.q, state, 0.1, 0.99, 0.1, 0, 512, cluster=cluster)
            for t in range(3):
                plan.step(t)
            return plan

        sizes = [c for c in (8, 4, 2, 1) if k5.step_blocks(b_k, ts_k.q.numel(), True) % c == 0]
        times = _in_turns({c: c for c in sizes}, lambda c: _plan_graph_ms(lambda: make_k(c), lambda p: p.step(2)))
        for cluster, ms in times.items():
            print(f"[ablation] this tree's K5 sharded step {tag} B={b_k} ({ts_k.q.numel()} entries), clusters of "
                  f"{cluster}: {[x * 1e3 for x in ms]!r} us in a CUDA graph of ten ({smi})")
    libs = _libraries([(HERE / "griduniverse_tpu_torch/csrc/td_fast.cu", OUT / f"new_k5_{i}", patches)
                       for i, patches in enumerate(K5_CUTS.values())])
    fns = {name: _entry(lib, "gu_td_step", build._SIGNATURES["gu_td_step"]) for name, lib in zip(K5_CUTS, libs)}
    cut_calls = {}
    for name, fn in fns.items():
        for cluster in (8, 2, 1):
            def call(plan, fn=fn):
                _checked("gu_td_step", fn(plan._addr, 1, 1, _stream()))

            cut_calls[f"{name}, clusters of {cluster}"] = (cluster, call)
    times = _in_turns(cut_calls, lambda pair: _plan_graph_ms(lambda: make(pair[0]), pair[1]))
    for name, ms in times.items():
        print(f"[ablation] this tree's K5 sharded step walls16 B=65536, {name}: {[x * 1e3 for x in ms]!r} us in a "
              f"CUDA graph of ten ({smi})")

    grids, _ = M.generate_mazes_device(2029, (80, 64), 64, "sidewinder", device=dev)
    n, h, w = 64, 161, 129
    cp = dp_grid.cluster_plan(h, w)
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
    args += [grids.data_ptr(), n, h, w, None]
    v0 = torch.zeros((n, h * w), device=dev)
    v_out = torch.empty_like(v0)
    maxima = torch.empty(16, device=dev)
    scratch = torch.zeros(dp_grid.PARTIAL_ROWS * 16 + 1, dtype=torch.int32, device=dev)
    partial, ticket = scratch.data_ptr(), scratch.data_ptr() + 4 * dp_grid.PARTIAL_ROWS * 16
    k4_calls = {}
    variants = _k4_variants()
    libs = _libraries([(HERE / "griduniverse_tpu_torch/csrc/dp_grid.cu", OUT / f"k4_{i}", patches)
                       for i, (patches, _, _) in enumerate(variants.values())])
    for lib, (name, (patches, threads, sweeps)) in zip(libs, variants.items()):
        fn = _entry(lib, "gu_grid_sweeps_cluster", build._SIGNATURES["gu_grid_sweeps_cluster"])
        cells = -(-cp.rows * w // threads)

        def call(fn=fn, cells=cells, sweeps=sweeps):
            _checked("gu_grid_sweeps_cluster", fn(*args, v0.data_ptr(), v_out.data_ptr(), 0.99, sweeps, cp.blocks,
                                                  cp.rows, cells, partial, dp_grid.PARTIAL_ROWS, maxima.data_ptr(),
                                                  ticket, _stream()))

        k4_calls[name] = call
        if name == "as built":
            for k in (3, 4, 6, 8):
                rows_k = -(-h // k)

                def call_k(fn=fn, k=k, rows_k=rows_k, cells_k=-(-rows_k * w // threads)):
                    _checked("gu_grid_sweeps_cluster", fn(*args, v0.data_ptr(), v_out.data_ptr(), 0.99, 16, k, rows_k,
                                                          cells_k, partial, dp_grid.PARTIAL_ROWS, maxima.data_ptr(),
                                                          ticket, _stream()))

                k4_calls[f"{k} bands a maze"] = call_k
    # each variant's first call alone: it must run, and a variant that cuts nothing gives as built's bits
    for name, call in k4_calls.items():
        call()
        torch.cuda.synchronize()
        out = (v_out.clone(), maxima.clone())
        if name == "as built":
            built_out = out
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, built_out))
        print(f"[ablation] K4 cluster tier variant {name}: ran; V and maxima equal to as built's: {same} ({smi})")
    times = _in_turns(k4_calls, lambda fn: (_graph_ms(fn), _events_ms(fn, reps=30)))
    for name, pairs in times.items():
        print(f"[ablation] this tree's K4 cluster tier, 64 mazes 161x129 ({cp}), {name}: "
              f"{[p[0] for p in pairs]!r} ms in a CUDA graph of ten, {[p[1] for p in pairs]!r} ms as timed ({smi})")


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("k5_k4_cluster_ablation: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt

    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    build.load()
    if "--old" in args:
        ablate_old_k5(Path(args[args.index("--old") + 1]).resolve(), gt, dev, smi)
    if "--new" in args:
        ablate_new(gt, dev, smi)


if __name__ == "__main__":
    main()
