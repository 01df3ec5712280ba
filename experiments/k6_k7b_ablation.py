"""What holds back K6's thread-a-maze scan over tables in device memory and
K7b's wrapper of one check and nine allocations a call (commit 14e74c0),
and what this tree's K6 costs by tier: each timed on one CUDA card. A
one-off experiment of the redesign, kept to reproduce its readings; it is
not part of the package.

    python -m experiments.k6_k7b_ablation [--old DIR] [--new]

From the root of a checkout, on a machine with a Hopper card and nvcc. DIR
is a tree of commit 14e74c0. It prints the card's name and power limit
(`nvidia-smi`), then:

With `--old DIR`, K6 as that commit wrote it (`csrc/td_batched.cu`: a
thread a maze, the (N, S, A) tables in device memory, the T loop inside one
launch), on 65,536 9x9 Aldous-Broder mazes for 2,000 Q-learning steps with
ε = 0.1 and native draws, in float32 and in bfloat16. The source is copied
with compile-time cuts added around exact lines of that commit (which do not
change), and built once for each value of `GU_K6_CUT`, a mask of:
- 1, "rows from a constant": each of the three rows a step reads is made
  from its state index, not loaded (the chain of dependent loads goes);
- 2, "words in shared memory": the block's packed levels are staged in
  shared memory once, and the step reads them there;
- 4, "algo and draws fixed": the algorithm and the draws' source are
  constants of the build, not branches on the kernel's arguments;
- 8, "one vector load a row": at A = 4 a row is one 16-byte load (8 in
  bfloat16), not four scalar ones.
Beside them, 2 | 4 | 8 (everything but the chain of loads) and 1 | 2 | 4
(no memory on the chain at all). Each is timed with CUDA events over two
scans after a warm-up, in turns (the cuts in order, then in reverse). A cut
kernel computes wrong tables; it is timed, never used.

Also K7b, one call at walls16 with B = 65,536 and A = 4 through that
commit's wrapper (`kernels/act_step.py` `act_step_cuda`, reproduced line by
line) on that commit's source, and with its host costs cut one at a time:
"without the checks" (the argument list built once) and "without the checks
and allocations" (the nine outputs allocated once too); each as timed over
200 calls, as the host's µs a call (the least of five rounds of 100 calls),
and as a call in a CUDA graph of ten (the device's own time).

With `--new`, this tree's K6 (`algos.td_batched.q_learning_batched`) at the
same shape in both dtypes, in three layouts (`kernels.td_batched.Plan`, put
in place of `plan` for the call): as planned, with the most tables that fit
a block (160 in float32, 320 in bfloat16, in waves), and with every maze on
device memory (`global_plan`); each for 2,000 steps and for none (the
set-up, the copies in and out and the first draw alone), timed in turns and
held bit for bit against the planned layout. Every variant runs once before
the turns, so that the allocator holds what all of them take.
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
from griduniverse_tpu_torch.tools.profile_turns import _events_ms, _host_us, _smi

OUT = Path("build/k6_k7b_ablation")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SEM = [_P, _P, _P, _P, _I]
_LEVEL = [_P, _I, _I, _P, _P, _I, _I]
# the C entries of commit 14e74c0, the stream last
OLD_TD_SIGNATURE = _SEM + _LEVEL + [_I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I] + [_P] * 4 + [_P] * 9 + [_P]
OLD_ACT_SIGNATURE = _SEM + _LEVEL + [_I, _I] + [_P] * 14 + [_P]

# (exact text of commit 14e74c0's csrc/td_batched.cu, its replacement with the cuts)
K6_CUT_PATCHES = (
    ("#include <cstdint>\n",
     "#include <cstdint>\n\n#ifndef GU_K6_CUT\n#define GU_K6_CUT 0\n#endif\n"
     "#define GU_K6_HAS(bit) ((GU_K6_CUT & (bit)) != 0)\n"),
    ("  for (int k = 0; k < na; ++k) row[k] = load_q(q + s * na + k);\n",
     "#if GU_K6_HAS(1)\n"
     "  for (int k = 0; k < na; ++k) row[k] = static_cast<float>((s + k) & 3);\n"
     "  return;\n"
     "#endif\n"
     "#if GU_K6_HAS(8)\n"
     "  if (na == 4) {\n"
     "    if constexpr (sizeof(QT) == 4) {\n"
     "      const float4 v = *reinterpret_cast<const float4*>(q + s * 4);\n"
     "      row[0] = v.x; row[1] = v.y; row[2] = v.z; row[3] = v.w;\n"
     "    } else {\n"
     "      const uint2 v = *reinterpret_cast<const uint2*>(q + s * 4);\n"
     "      row[0] = __uint_as_float(v.x << 16); row[1] = __uint_as_float(v.x & 0xffff0000u);\n"
     "      row[2] = __uint_as_float(v.y << 16); row[3] = __uint_as_float(v.y & 0xffff0000u);\n"
     "    }\n"
     "    return;\n"
     "  }\n"
     "#endif\n"
     "  for (int k = 0; k < na; ++k) row[k] = load_q(q + s * na + k);\n"),
    ("  __shared__ gu::Tables tab;\n  gu::load_tables(",
     "  __shared__ gu::Tables tab;\n"
     "#if GU_K6_HAS(2)\n"
     "  __shared__ uint32_t s_lw[kThreads * 8];\n"
     "  for (int i = threadIdx.x; i < kThreads * g.n_words; i += kThreads) {\n"
     "    const size_t gi = static_cast<size_t>(blockIdx.x) * kThreads * g.n_words + i;\n"
     "    if (gi < static_cast<size_t>(g.n) * g.n_words) s_lw[i] = g.words[gi];\n"
     "  }\n"
     "#endif\n"
     "  gu::load_tables("),
    ("  const uint32_t* lw = g.words + static_cast<size_t>(n) * g.n_words;\n",
     "#if GU_K6_HAS(2)\n"
     "  const uint32_t* lw = s_lw + threadIdx.x * g.n_words;\n"
     "#else\n"
     "  const uint32_t* lw = g.words + static_cast<size_t>(n) * g.n_words;\n"
     "#endif\n"),
    ("  const bool injected = g.explore != nullptr;\n",
     "#if GU_K6_HAS(4)\n"
     "  constexpr bool injected = false;\n"
     "  constexpr int algo = kQLearning;\n"
     "#else\n"
     "  const bool injected = g.explore != nullptr;\n"
     "  const int algo = g.algo;\n"
     "#endif\n"),
    ("    if (g.algo == kSarsa) {", "    if (algo == kSarsa) {"),
    ("      if (g.algo == kQLearning) {", "      if (algo == kQLearning) {"),
)
K6_CUTS = {"as built": 0, "rows from a constant": 1, "words in shared memory": 2, "algo and draws fixed": 4,
           "one vector load a row": 8, "all but the chain of loads (2|4|8)": 14, "no memory on the chain (1|2|4)": 7}


def _library(src: Path, out_dir: Path, patches=(), defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """`src` with each (old, new) of `patches` replaced, built with `defines`
    (-D) into a library of its own."""
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"k6_k7b_ablation: {src} does not hold `{old.strip()}` exactly once")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / src.name, out_dir / f"lib{src.stem}.so"
    cu.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-I", str(src.parent),
                           "-shared", "-o", str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"k6_k7b_ablation: nvcc failed on {cu} {defines}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _entry(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(name: str, code: int) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def _stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _mazes(gt, dev, n):
    from griduniverse_tpu_torch.levels import maze as M

    grids, start = M.generate_mazes_device(2026, (4, 4), n, "aldous_broder", device=dev)
    return gt.Level(grid=grids.contiguous(), start_idx=start.expand(n).contiguous())


def ablate_k6(old: Path, gt, dev, smi) -> None:
    from griduniverse_tpu_torch.algos import td_batched
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem = gt.make_semantics(device=dev)
    n, steps, eps = 65_536, 2_000, 0.1
    levels = _mazes(gt, dev, n)
    bl = bp.pack_level(levels)
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
    args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, n, dev)
    src = old / "griduniverse_tpu_torch/csrc/td_batched.cu"
    fns = {name: _entry(_library(src, OUT / f"k6_{cut}", K6_CUT_PATCHES, (f"GU_K6_CUT={cut}",)),
                        "gu_td_batched", OLD_TD_SIGNATURE)
           for name, cut in K6_CUTS.items()}
    calls = {}
    for dtype in ("float32", "bfloat16"):
        st0 = td_batched._init_state(sem, bl, 9, None, dtype)
        scalars = td_batched.target_scalars(0.99, eps, dtype == "bfloat16")
        for name, fn in fns.items():
            q = st0.q.clone()
            state = [x.clone() for x in (st0.env_state.agent_idx, st0.env_state.agent_code, st0.env_state.t,
                                         st0.a, st0.rs, st0.run_ret, st0.n_eps_env, st0.ret_sum_env)]
            first = [1]

            def call(fn=fn, q=q, state=state, first=first, dtype=dtype, scalars=scalars):
                # the scan runs on the table and the state in place, a scan after the last
                _checked("gu_td_batched", fn(
                    *args, n, steps, 512, 0, int(dtype == "bfloat16"), 0.1, scalars[0], scalars[2], scalars[1],
                    int(eps * 65536.0), first[0], None, None, None, None, q.data_ptr(),
                    *[x.data_ptr() for x in state], _stream()))
                first[0] = 0

            calls[f"{dtype}, {name}"] = call
    times: dict[str, list[float]] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times.setdefault(name, []).append(_events_ms(calls[name], reps=2))
    for name, ms in times.items():
        print(f"[ablation] K6 of 14e74c0, {n} mazes 9x9 T={steps} eps={eps}, {name}: {ms!r} ms a scan ({smi})")


def ablate_k7b(old: Path, gt, dev, smi) -> None:
    from griduniverse_tpu_torch import kernels
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.models import a2c
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.ops.bitplane import _sem_level_args

    sem = gt.make_semantics(device=dev)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    b, a = 65_536, 4
    gen = torch.Generator(device=dev).manual_seed(0)
    st = bp.reset_bits(bl, b)
    logits = 2 * torch.randn((b, a), generator=gen, device=dev)
    noise = a2c.draw_gumbel(gen, (b, a), dev)
    fn = _entry(_library(old / "griduniverse_tpu_torch/csrc/act_step.cu", OUT / "k7b"), "gu_act_step",
                OLD_ACT_SIGNATURE)

    def old_args(logits_, noise_):
        """The checks and argument list of that commit's `act_step_cuda`."""
        args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
        args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
        args += [b, 64]
        for name, x, dtype, shape in (("logits", logits_, torch.float32, (b, a)),
                                      ("gumbel", noise_, torch.float32, (b, a)),
                                      ("agent_idx", st.agent_idx, torch.int32, (b,)),
                                      ("agent_code", st.agent_code, torch.int32, (b,)), ("t", st.t, torch.int32, (b,))):
            args.append(build.check_tensor(name, x, dtype, shape, dev))
        return args

    def old_outputs():
        i32 = dict(dtype=torch.int32, device=dev)
        return [torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **i32),
                torch.empty(b, dtype=torch.bool, device=dev), torch.empty(b, **i32),
                torch.empty(b, dtype=torch.float32, device=dev), torch.empty(b, **i32),
                torch.empty(b, dtype=torch.float32, device=dev), torch.empty(b, dtype=torch.bool, device=dev)]

    def as_written():
        # that commit's `a2c.act_step` and `act_step_cuda`, line by line
        if not kernels.on_cuda(logits, noise, st.agent_idx, bl.code_words, sem.deltas):
            raise SystemExit("k6_k7b_ablation: the tensors are not on the card")
        _sem_level_args(sem, bl)
        args = old_args(logits.contiguous(), noise.contiguous())
        outs = old_outputs()
        _checked("gu_act_step", fn(*args, *[o.data_ptr() for o in outs], _stream()))
        return bp.FastState(*outs[:4]), *outs[4:]

    fixed_args = old_args(logits, noise)
    fixed_outs = [o.data_ptr() for o in old_outputs()]

    def without_checks():
        outs = old_outputs()
        _checked("gu_act_step", fn(*fixed_args, *[o.data_ptr() for o in outs], _stream()))

    def without_allocations():
        _checked("gu_act_step", fn(*fixed_args, *fixed_outs, _stream()))

    calls = {"as written (checks, nine allocations, one launch)": as_written, "without the checks": without_checks,
             "without the checks and allocations": without_allocations}
    times: dict[str, list[tuple[float, float, float]]] = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            fn_ = calls[name]
            times.setdefault(name, []).append((_events_ms(fn_, reps=200), _host_us(fn_), _graph_ms(fn_)))
    for name, triples in times.items():
        print(f"[ablation] K7b of 14e74c0, walls16 B={b} A={a}, {name}: {[t[0] for t in triples]!r} ms a call as "
              f"timed, {[t[1] for t in triples]!r} us of host time a call, {[t[2] for t in triples]!r} ms a call in "
              f"a CUDA graph ({smi})")


def k6_layouts(gt, dev, smi) -> None:
    from griduniverse_tpu_torch.algos import td_batched
    from griduniverse_tpu_torch.kernels import td_batched as k6

    sem = gt.make_semantics(device=dev)
    n, steps = 65_536, 2_000
    levels = _mazes(gt, dev, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s, a = levels.num_states, sem.num_actions
    planned = k6.plan
    calls, outs = {}, {}
    for dtype in ("float32", "bfloat16"):
        itemsize = 4 if dtype == "float32" else 2
        most = max(t for t in range(32, k6.MAX_THREADS + 1, 32)
                   if k6.shared_bytes(t, s, a, itemsize) <= k6.SHARED_BYTES)
        layouts = {
            "as planned": planned(s, a, dtype, n, sms=sms),
            "the most tables that fit a block": k6.Plan("shared", most, -(-n // most),
                                                        k6.shared_bytes(most, s, a, itemsize)),
            "all in device memory": k6.global_plan(n),
        }
        for name, layout in layouts.items():
            for t in (steps, 0):  # 0: the set-up, the copies in and out and the first draw alone
                def call(dtype=dtype, layout=layout, name=name, t=t):
                    k6.plan = lambda *_, **__: layout
                    try:
                        res = td_batched.q_learning_batched(sem, levels, 9, t, dtype=dtype, max_episode_steps=512)
                    finally:
                        k6.plan = planned
                    if t:
                        outs[(dtype, name)] = res

                calls[(dtype, f"{name}, T={t}", layout)] = call
    for call in calls.values():  # every variant once, so that the allocator holds what all of them take
        call()
    times: dict = {}
    for order in (list(calls), list(calls)[::-1]):
        for key in order:
            times.setdefault(key, []).append(_events_ms(calls[key], reps=2))
    for (dtype, name, layout), ms in times.items():
        print(f"[ablation] this tree's K6, {n} mazes 9x9 {dtype}, {name} ({layout}): {ms!r} ms a run ({smi})")
    for dtype in ("float32", "bfloat16"):
        ref = outs[(dtype, "as planned")].q
        for (d, name), res in outs.items():
            if d == dtype and not torch.equal(res.q.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                                              ref.view(torch.int16 if dtype == "bfloat16" else torch.int32)):
                raise SystemExit(f"k6_k7b_ablation: {dtype} {name} gives other tables than the planned layout")
    print("[ablation] this tree's K6: every layout gives the same tables bit for bit in both dtypes")


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("k6_k7b_ablation: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt

    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    if "--old" in args:
        old = Path(args[args.index("--old") + 1]).resolve()
        ablate_k6(old, gt, dev, smi)
        ablate_k7b(old, gt, dev, smi)
    if "--new" in args:
        k6_layouts(gt, dev, smi)


if __name__ == "__main__":
    main()
