"""One device program a call: a trainer's step, or update, captured once a
call in a CUDA graph and replayed. The port's counterpart of the
reference's `jax.jit` of one `lax.scan` over a run; the JAX package has no
module of its own for it.

A run is a `Program` over a flat list of tensors, its static buffers (the
train state, copied once by the caller). `Program.body(state, generator,
inputs)` is one step: it reads the buffers and returns each one's new
value, in the same order; `write_back` copies those into the buffers, so
that the next step reads them (a buffer the body wrote in place, or left
alone, comes back as itself and is not copied). The body reads no device
value on the host.

Draws: a step's generator is one `torch.Generator` a call, seeded with
`Program.seeds(i)` before step i, which gives the draws of a fresh
generator seeded alike; `Program.inputs(i)`, the caller's injected draws,
are copied into static input buffers before step i.

`run(name, state, make_program, num_steps)`:
  * on the CPU, the body eagerly, step after step, over the same buffers;
  * on the card, on the device's side stream: the program built there (the kernels'
    stream-ordered plans with it), the kernels built, one step on a clone of
    the state with `torch.cuda.set_sync_debug_mode("error")`, the last
    call's graph and the allocator's cache released (the host waits for
    the last call's replays), one step captured in a `torch.cuda.CUDAGraph`
    with the generator registered, then the graph replayed `num_steps`
    times. A capture or a replay that fails raises; nothing gives way to
    the eager loop.

`kernels.LAUNCHES` counts launches: a capture launches nothing, so the
counts it adds are taken back and kept as the graph's launches a replay,
which each replay adds. `COUNTS` keeps the captures, the warm-up steps
and the replays, and `LAST[name]` the last captured call's figures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch

from .. import kernels

WARMUP_STEPS = 1  # eager steps on a clone of the state before a capture

COUNTS: dict[str, int] = {"captures": 0, "warmup_steps": 0, "replays": 0}

# (event, graph, steps) of the last call, whose replays may still run: its
# graph, memory pool and generator are kept until the next call's capture
# (`_release`), so that a call returns before its run ends
_IN_FLIGHT: list[tuple] = []

# one side stream a device for every call: the library workspaces that are
# kept a stream (cuBLAS's) are made once, not once a call
_SIDE: dict[int, torch.cuda.Stream] = {}


@dataclasses.dataclass
class CaptureRecord:
    """One captured call: its replays, the host ms of the capture (the
    instantiation included), the bytes the graph's private memory pool
    reserved, the kernel launches of one replay by `LAUNCHES` name, and two
    CUDA events around the replays on the card."""

    replays: int
    capture_ms: float
    pool_bytes: int
    launches: dict[str, int]
    events: tuple = ()

    def replays_ms(self) -> float:
        """The card's ms from the first replay's start to the last one's end
        (it waits for them)."""
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


LAST: dict[str, CaptureRecord] = {}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


@dataclasses.dataclass
class Program:
    """One step of a run, as `run` drives it."""

    body: Callable                  # body(state, generator, inputs) -> the new state, a tensor a buffer
    seeds: Callable | None = None   # step i -> the seed of its generator; None where the body draws nothing
    inputs: Callable | None = None  # step i -> its injected draws, a list of tensors
    bind: Callable | None = None    # bind(state): the host's checks of a state, before a step runs on it


def write_back(state: list, new: list) -> None:
    """Copy each new value into its buffer, one `torch._foreach_copy_` a
    dtype; a value that is its buffer is left."""
    if len(new) != len(state):
        raise ValueError(f"a step returned {len(new)} tensors for {len(state)} buffers")
    groups: dict[torch.dtype, tuple[list, list]] = {}
    for dst, src in zip(state, new):
        if src is dst:
            continue
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(f"a step returned a {src.dtype} {tuple(src.shape)} tensor for a {dst.dtype} "
                             f"{tuple(dst.shape)} buffer")
        dsts, srcs = groups.setdefault(dst.dtype, ([], []))
        dsts.append(dst)
        srcs.append(src)
    for dsts, srcs in groups.values():
        torch._foreach_copy_(dsts, srcs)


class Steps:
    """What the steps of a run share: its program, the generator and the
    static input buffers (made from step 0's draws)."""

    def __init__(self, program: Program, device: torch.device):
        self.program = program
        self.generator = None if program.seeds is None else torch.Generator(device=device)
        self.inputs = None
        if program.inputs is not None:
            self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=device) for x in program.inputs(0)]

    def load(self, i: int) -> None:
        """Step i's draws: the generator seeded, the injected draws copied."""
        if self.generator is not None:
            self.generator.manual_seed(self.program.seeds(i))
        if self.inputs is not None:
            for dst, src in zip(self.inputs, self.program.inputs(i)):
                dst.copy_(src)

    def step(self, state: list) -> None:
        """One step over `state`, its new values written back."""
        write_back(state, self.program.body(state, self.generator, self.inputs))


def run(name: str, state: list, make_program: Callable[[], Program], num_steps: int) -> list:
    """`num_steps` steps of the program `make_program()` over the buffers
    `state`, which end holding the run's last state (module docstring).
    `make_program` is called once, on the stream the steps run on."""
    device = state[0].device
    if device.type != "cuda":
        steps = Steps(make_program(), device)
        for i in range(num_steps):
            steps.load(i)
            steps.step(state)
        return state
    if num_steps == 0:
        return state
    from ..kernels import build

    build.load()
    caller = torch.cuda.current_stream(device)
    if caller.device_index not in _SIDE:
        _SIDE[caller.device_index] = torch.cuda.Stream(device)
    side = _SIDE[caller.device_index]
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        steps = Steps(make_program(), device)
        _warm_up(steps, state)
        _release()
        graph, record = _capture(steps, state, num_steps)
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(side)
        for i in range(num_steps):
            steps.load(i)
            graph.replay()
        done.record(side)
        COUNTS["replays"] += num_steps
        for kernel, n in record.launches.items():
            kernels.LAUNCHES[kernel] += n * num_steps
        record.events = (start, done)
    caller.wait_stream(side)
    _IN_FLIGHT.append((done, graph, steps))
    LAST[name] = record
    return state


def _warm_up(steps: Steps, state: list) -> None:
    """`WARMUP_STEPS` eager steps on a clone of the state, with any host
    read raising: the library handles, the side stream's workspaces and
    the lazy set-up are made here, and the run's own state does not move."""
    bind = steps.program.bind
    warm = [x.clone() for x in state]
    if bind is not None:
        bind(warm)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(WARMUP_STEPS):
            steps.load(i)
            steps.step(warm)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    COUNTS["warmup_steps"] += WARMUP_STEPS
    if bind is not None:
        bind(state)


def _release() -> None:
    """Before a capture: the earlier calls' graphs dropped once the card has
    run their replays, and the allocator's cached blocks (the warm-up's,
    kept for the side stream, and the dropped graphs' pools) given back to
    the card. A new graph's private pool can use neither, and no block is freed
    while a capture runs, so without this each call would hold its own
    pool and its warm-up's blocks until the card ran out."""
    for done, *_ in _IN_FLIGHT:
        done.synchronize()
    _IN_FLIGHT.clear()
    torch.cuda.empty_cache()


def _capture(steps: Steps, state: list, num_steps: int) -> tuple[torch.cuda.CUDAGraph, CaptureRecord]:
    """One step over `state` captured on the current stream (nothing
    runs); the launch counts it added taken back as the graph's own."""
    graph = torch.cuda.CUDAGraph()
    if steps.generator is not None:
        graph.register_generator_state(steps.generator)
    before = dict(kernels.LAUNCHES)
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graph.capture_begin()
    try:
        steps.step(state)
    except BaseException:
        with contextlib.suppress(RuntimeError):  # the capture's own error is the one to raise
            graph.capture_end()
        raise
    finally:
        launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
        kernels.LAUNCHES.update(before)
    graph.capture_end()
    ms = (time.perf_counter() - t0) * 1e3
    COUNTS["captures"] += 1
    return graph, CaptureRecord(num_steps, ms, torch.cuda.memory_reserved() - reserved, launches)
