"""What holds back K5's and K7c's one-launch-a-step designs (commit 0404059),
and what K5's persistent scan of this tree costs: each source built with one
cost cut at a time, timed on one CUDA card. A one-off experiment of the
redesign, kept to reproduce its readings; it is not part of the package.

    python -m experiments.k5_k7c_ablation [--old DIR] [--new]

From the root of a checkout, on a machine with a Hopper card and nvcc. DIR
is a tree of commit 0404059, whose `csrc/td_fast.cu` is K5 as one step
kernel a step and a last kernel that applies the final aggregate, and whose
`csrc/dqn_act.cu` is K7c as the act-and-step pass and a one-thread fold.
The cuts of `--old` replace exact lines of that commit's sources, which do
not change. It prints the card's name and power limit (`nvidia-smi`), then
builds each source into a library of its own under
`build/k5_k7c_ablation/`, as it is and with one cost cut:

K5, a 2,000-step scan at walls16 with B = 65,536 and ε = 1, so that no
env's path depends on Q and every cut steps the envs along the same cells
(the main path's ε = 0.1 is timed as built beside them):
- "empty steps": every step kernel returns at once: the 2,001 launches and
  their gaps alone;
- "without the rebuild": each block stages Q_t as zeros instead of reading
  Q_{t-1} and the step's aggregate from L2 and applying it;
- "without the aggregate": no env adds its α·δ into the block's shared
  counters, so the flush finds nothing to add to the global ones either;
- "without the flush": the shared adds stay, the global atomics go.

K7c, one call at walls16 with B = 65,536 and A = 4, on the wrapper as that
tree wrote it (`kernels/dqn_act.py`, `models/dqn.py` `dqn_act_step`), and
with its host costs cut one at a time:
- "without the checks": the argument list built once;
- "without the checks and allocations": the outputs allocated once too;
- "one launch": the same, with the fold's launch cut from the source.

With `--new`, this tree's `csrc/td_fast.cu` (one cooperative launch a
scan) at the same shape on the wrapper's grid (`grid_plan`), as built and
with one cost cut by the source's own `GU_K5_CUT` (as built and without
the combine also at the main path's ε = 0.1):
- "barriers only": each step is its grid barrier and nothing else;
- "without the flush": the block's shared counters never reach the global
  ones (no global atomics);
- "without the combine": each lane adds its own α·δ and count to the
  block's counters, with no combining across the warp first;
- "without the apply": no block reads the step's aggregate back to advance
  its Q.

Each is timed with CUDA events around the calls after a warm-up (K5: 3
scans, K7c: 200 calls), in turns (the variants in order, then in reverse),
and for K7c also as the host's time of a call (the least of five rounds of
100 calls with no synchronize inside). The cut versions compute wrong
values; they are timed, never used.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.kernels.rollout import level_args, semantics_args
from griduniverse_tpu_torch.tools.profile_turns import _events_ms, _host_us, _smi

HERE = Path(__file__).resolve().parents[1]
OUT = Path("build/k5_k7c_ablation")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SEM = [_P, _P, _P, _P, _I]
_LEVEL = [_P, _I, _I, _P, _P, _I, _I]
# the C entries of commit 0404059, the stream last
OLD_TD_SIGNATURE = _SEM + _LEVEL + [_I, _I, _I, _I, _F, _F, _F, _F, _I] + [_P] * 13 + [_P]
OLD_ACT_SIGNATURE = _SEM + _LEVEL + [_I, _I] + [_P] * 9 + [_P] * 11 + [_P] * 2 + [_P]

_STAGE = "const float q = rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, i);"
_SHARED_ADD = """      atomicAdd(&s_acc[cell], static_cast<unsigned long long>(inc));
      atomicAdd(&s_cnt[cell], 1);"""
K5_CUTS = {
    "as built": {},
    "empty steps": {"  __shared__ gu::Tables tab;\n  __shared__ uint32_t s_words[gu::kMaxWords];\n  const int n_entries":
                    "  if (g.batch > 0) return;\n  __shared__ gu::Tables tab;\n"
                    "  __shared__ uint32_t s_words[gu::kMaxWords];\n  const int n_entries"},
    "without the rebuild": {_STAGE: "const float q = 0.0f;"},
    # the α·δ is still computed: a store that never happens keeps it
    "without the aggregate": {_SHARED_ADD: "      if (inc == 0x7fffffffffffffffll) s_cnt[cell] = 1;"},
    "without the flush": {"    if (c != 0) {\n      atomicAdd(&acc_cur[i]": "    if (c == -1) {\n      atomicAdd(&acc_cur[i]"},
}
# GU_K5_CUT of this tree's `csrc/td_fast.cu`
NEW_K5_CUTS = {"as built": 0, "barriers only": 1, "without the flush": 2, "without the combine": 3,
               "without the apply": 4}
_FOLD = "  dqn_fold_stats_kernel<<<1, 1, 0, st>>>("
K7C_ONE_LAUNCH = {_FOLD: "  if (batch < 0) dqn_fold_stats_kernel<<<1, 1, 0, st>>>("}


def _library(src: Path, out_dir: Path, patches: dict[str, str], defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """`src` with each key replaced by its value, built with `defines` (-D)
    into a library of its own."""
    text = src.read_text()
    for old, new in patches.items():
        if old not in text:
            raise SystemExit(f"k5_k7c_ablation: {src} has no `{old}`")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / src.name, out_dir / f"lib{src.stem}.so"
    cu.write_text(text)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-I", str(src.parent),
                    "-shared", "-o", str(lib), str(cu)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _entry(lib: ctypes.CDLL, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(name: str, code: int) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def ablate_k5(old: Path, gt, dev, smi) -> None:
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem = gt.make_semantics(device=dev)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    b, steps = 65_536, 2_000
    ts = td_fast.fast_td_init(sem, bl, 7, b)
    n_entries = bl.num_states * sem.num_actions
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
    args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
    st = ts.env_state
    state_in = (st.agent_idx, st.agent_code, st.t, ts.rs, ts.run_ret, ts.n_eps_env, ts.ret_sum_env)
    q_out = torch.empty_like(ts.q)
    q_buf = torch.empty((2, n_entries), device=dev)
    acc = torch.empty((3, n_entries), dtype=torch.int64, device=dev)
    cnt = torch.empty((3, n_entries), dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    calls = {}
    for i, (name, patches) in enumerate(K5_CUTS.items()):
        fn = _entry(_library(old / "griduniverse_tpu_torch/csrc/td_fast.cu", OUT / f"k5_{i}", patches),
                    "gu_td_scan_fast", OLD_TD_SIGNATURE)
        for eps in ((1.0, 0.1) if name == "as built" else (1.0,)):
            state = [x.clone() for x in state_in]

            def call(fn=fn, eps=eps, state=state):
                # the scan runs on the state in place; each call restarts from the initial state
                for x, x0 in zip(state, state_in):
                    x.copy_(x0)
                _checked("gu_td_scan_fast", fn(
                    *args, b, steps, 512, 0, 0.1, 0.99, eps, 1.0 - eps, int(eps * 65536.0), ts.q.data_ptr(),
                    q_out.data_ptr(), *[x.data_ptr() for x in state], q_buf.data_ptr(), acc.data_ptr(),
                    cnt.data_ptr(), ctypes.addressof(launched), torch.cuda.current_stream().cuda_stream))

            calls[f"{name}, eps={eps}"] = call
    # the copies that restart each scan, timed alone to be taken off
    state = [x.clone() for x in state_in]
    calls["the seven copies that restart a scan"] = lambda: [x.copy_(x0) for x, x0 in zip(state, state_in)]
    times: dict[str, list[float]] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times.setdefault(name, []).append(_events_ms(calls[name], reps=3))
    for name, ms in times.items():
        print(f"[ablation] K5 walls16 B={b} T={steps}, {name}: {ms!r} ms a scan ({smi})")


def ablate_k5_new(gt, dev, smi) -> None:
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.kernels import td_fast as k5
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem = gt.make_semantics(device=dev)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    b, steps = 65_536, 2_000
    ts = td_fast.fast_td_init(sem, bl, 7, b)
    n_entries = bl.num_states * sem.num_actions
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
    args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
    st = ts.env_state
    state_in = (st.agent_idx, st.agent_code, st.t, ts.rs, ts.run_ret, ts.n_eps_env, ts.ret_sum_env)
    state_out = [torch.empty_like(x) for x in state_in]
    q_out = torch.empty_like(ts.q)
    acc = torch.empty((3, n_entries), dtype=torch.int64, device=dev)
    cnt = torch.empty((3, n_entries), dtype=torch.int32, device=dev)
    plan = k5.grid_plan(b, k5._resident(dev, n_entries, 1)[1], lambda ept: k5._resident(dev, n_entries, ept)[0])
    grid = f"{plan.blocks} blocks, {plan.walks} env a thread (the wrapper's grid)"
    calls = {}
    for name, cut in NEW_K5_CUTS.items():
        fn = _entry(_library(HERE / "griduniverse_tpu_torch/csrc/td_fast.cu", OUT / f"new_k5_{cut}", {},
                             (f"GU_K5_CUT={cut}",)),
                    "gu_td_scan_fast", build._SIGNATURES["gu_td_scan_fast"])
        for eps in ((1.0, 0.1) if name in ("as built", "without the combine") else (1.0,)):
            def call(fn=fn, eps=eps):
                _checked("gu_td_scan_fast", fn(
                    *args, b, steps, 512, 0, 0.1, 0.99, eps, 1.0 - eps, int(eps * 65536.0), plan.blocks, plan.ept,
                    plan.walks, ts.q.data_ptr(), q_out.data_ptr(), *[x.data_ptr() for x in state_in],
                    *[x.data_ptr() for x in state_out], None, acc.data_ptr(), cnt.data_ptr(),
                    torch.cuda.current_stream().cuda_stream))

            calls[f"{name}, {grid}, eps={eps}"] = call
    times: dict[str, list[float]] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times.setdefault(name, []).append(_events_ms(calls[name], reps=3))
    for name, ms in times.items():
        print(f"[ablation] this tree's K5, walls16 B={b} T={steps}, {name}: {ms!r} ms a scan ({smi})")


def ablate_k7c(old: Path, gt, dev, smi) -> None:
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.ops.bitplane import _sem_level_args

    sem = gt.make_semantics(device=dev)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    b = 65_536
    gen = torch.Generator(device=dev).manual_seed(0)
    st = bp.reset_bits(bl, b)
    q = torch.randn((b, 4), generator=gen, device=dev)
    explore = torch.rand(b, generator=gen, device=dev) < 0.05
    rand_a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
    run_ret = torch.zeros(b, device=dev)
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), device=dev)
    fns = {name: _entry(_library(old / "griduniverse_tpu_torch/csrc/dqn_act.cu", OUT / f"k7c_{i}", patches),
                        "gu_dqn_act_step", OLD_ACT_SIGNATURE)
           for i, (name, patches) in enumerate((("two launches", {}), ("one launch", K7C_ONE_LAUNCH)))}

    def old_args(q_):
        """The checks and argument list of that tree's wrapper."""
        args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
        args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
        args += [b, 16]
        for name, x, dtype, shape in (("q", q_, torch.float32, (b, 4)), ("explore", explore, torch.bool, (b,)),
                                      ("rand_a", rand_a, torch.int32, (b,)), ("agent_idx", st.agent_idx, torch.int32, (b,)),
                                      ("agent_code", st.agent_code, torch.int32, (b,)), ("t", st.t, torch.int32, (b,)),
                                      ("run_ret", run_ret, torch.float32, (b,)), ("episodes", episodes, torch.int64, ()),
                                      ("ret_sum", ret_sum, torch.float32, ())):
            args.append(build.check_tensor(name, x, dtype, shape, dev))
        return args

    def old_outputs():
        i32, f32, flag = (dict(dtype=d, device=dev) for d in (torch.int32, torch.float32, torch.bool))
        outs = [torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **flag),
                torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **f32), torch.empty(b, **flag),
                torch.empty(b, **f32), torch.empty((), dtype=torch.int64, device=dev), torch.empty((), **f32)]
        chunks = -(-b // 256)
        return outs + [torch.empty(chunks, **f32), torch.empty(chunks, **i32)]

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())

    def as_written():
        # that tree's `dqn_act_step` and `dqn_act_step_cuda`, line by line
        with build._lock:  # as `build.launch` takes it to load the library
            pass
        q_ = q.float()
        if not kernels.on_cuda(q_, explore, rand_a, st.agent_idx, run_ret, bl.code_words, sem.deltas):
            raise SystemExit("k5_k7c_ablation: the tensors are not on the card")
        _sem_level_args(sem, bl)
        args = old_args(q_.contiguous())
        explore.contiguous(), rand_a.to(torch.int32).contiguous(), run_ret.contiguous()
        episodes.reshape(()), ret_sum.reshape(())
        outs = old_outputs()
        _checked("gu_dqn_act_step", fns["two launches"](*args, *[o.data_ptr() for o in outs], stream()))

    fixed_args = old_args(q)
    fixed_outs = [o.data_ptr() for o in old_outputs()]

    def without_checks():
        outs = old_outputs()
        _checked("gu_dqn_act_step", fns["two launches"](*fixed_args, *[o.data_ptr() for o in outs], stream()))

    def without_allocations():
        _checked("gu_dqn_act_step", fns["two launches"](*fixed_args, *fixed_outs, stream()))

    def one_launch():
        _checked("gu_dqn_act_step", fns["one launch"](*fixed_args, *fixed_outs, stream()))

    calls = {"as written (checks, 13 allocations, two launches)": as_written, "without the checks": without_checks,
             "without the checks and allocations": without_allocations, "one launch": one_launch}
    times: dict[str, list[float]] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times.setdefault(name, []).append((_events_ms(calls[name], reps=200), _host_us(calls[name])))
    for name, pairs in times.items():
        print(f"[ablation] K7c walls16 B={b} A=4, {name}: {[p[0] for p in pairs]!r} ms a call as timed, "
              f"{[p[1] for p in pairs]!r} us of host time a call ({smi})")


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("k5_k7c_ablation: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt

    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    if "--old" in args:
        old = Path(args[args.index("--old") + 1]).resolve()
        ablate_k5(old, gt, dev, smi)
        ablate_k7c(old, gt, dev, smi)
    if "--new" in args:
        ablate_k5_new(gt, dev, smi)


if __name__ == "__main__":
    main()
