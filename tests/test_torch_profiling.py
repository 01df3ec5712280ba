"""The port's tracing and timing helpers (`utils/profiling.py`) on CPU
values: a fence returns what it was given, the timers measure the fenced
call, and `trace` writes a trace file."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import profiling


@dataclasses.dataclass
class _Box:
    x: torch.Tensor
    rest: tuple


def test_fence_returns_its_value_and_finds_every_tensor():
    box = _Box(torch.ones(3), ({"a": torch.zeros(2)}, [torch.arange(4)], 5, "s"))
    assert profiling.fence(box) is box
    assert [t.numel() for t in profiling._tensors(box)] == [3, 2, 4]
    st = tbp.FastState(*(torch.zeros(2, dtype=torch.int32) for _ in range(3)), torch.zeros(2, dtype=torch.bool))
    assert len(list(profiling._tensors(st))) == 4
    assert profiling.fence(None) is None and profiling.fence(7) == 7
    assert list(profiling._tensors(_Box)) == []  # a dataclass type is not a value


def test_timer_measures_the_fenced_block():
    with profiling.Timer() as t:
        time.sleep(0.02)
        out = t.block_on(torch.ones(4) * 2)
    assert torch.equal(out, torch.full((4,), 2.0))
    assert 0.015 < t.elapsed < 5
    with profiling.Timer() as t2:
        pass
    assert t2.elapsed is not None and t2.elapsed < t.elapsed


def test_time_fn_and_steps_per_second():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        time.sleep(0.01)
        return torch.full((2,), x * scale)

    dt, out = profiling.time_fn(fn, 3.0, repeats=3, warmup=2, scale=2.0)
    assert len(calls) == 5 and torch.equal(out, torch.full((2,), 6.0))
    assert 0.008 < dt < 5
    rate = profiling.steps_per_second(fn, 1000, 1.0, repeats=3)
    assert 200 < rate < 125_000


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        y = torch.randn(64, 64) @ torch.randn(64, 64)
        profiling.fence(y)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())

