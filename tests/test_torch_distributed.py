"""Multi-process drills of the PyTorch port: real OS processes on Gloo.

Counterparts of `tests/test_distributed_multiprocess.py:157,181,253` and
`tests/test_fault_tolerance.py:74,162`. Each process is a subprocess
(`python -m tests.torch_parallel_worker MODE ...`) with a timeout of its
own, and every rank's collectives have a process-group timeout, so a hang
fails its test:

  * the learner in parity mode across the process boundary equals the
    single-process `td_run` bit for bit;
  * the sharded fast rollout steps the unsharded rollout's envs;
  * a killed peer makes the survivor's next collective raise within its
    timeout instead of hanging;
  * a SIGKILL mid-run, then a restart from the latest checkpoint
    (`utils/checkpoint.py`), gives `td_run`'s and the fast engine's
    unbroken run bit for bit.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from griduniverse_tpu_torch import algos
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils.checkpoint import CheckpointManager, flatten

from tests import torch_parallel_worker as W

REPO = Path(__file__).resolve().parent.parent
PROCESS_TIMEOUT_S = 180


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(mode, rank, world, port, out):
    return subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_worker", mode, str(rank), str(world), str(port), str(out)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _wait_all(procs):
    """Wait for every process up to its timeout; kill and fail on one that
    hangs. Returns [(returncode, stderr)]."""
    deadline = time.monotonic() + PROCESS_TIMEOUT_S
    out = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank did not end within {PROCESS_TIMEOUT_S} s")
        out.append((p.returncode, err))
    return out


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The two-process learner and rollout, as rank 0 saved them."""
    out = tmp_path_factory.mktemp("sharded") / "rank0.pt"
    port = W.free_port()
    results = _wait_all([_spawn("sharded", r, 2, port, out) for r in range(2)])
    for code, err in results:
        assert code == 0, err[-2000:]
    return torch.load(out, weights_only=False)


def test_multiprocess_learner_bitexact_vs_single_process(sharded_run):
    inp = W.make_inputs()
    ref = algos.q_learning(inp["sem"], inp["lava"], 7, W.T_TD, W.B_TD, **W.TD_KW)
    assert torch.equal(sharded_run["q"].view(torch.int32), ref.q.view(torch.int32))
    assert int(sharded_run["episodes"]) == int(ref.episodes) > 0


def test_multiprocess_fast_rollout_matches_unsharded(sharded_run):
    inp = W.make_inputs()
    state, stats = tbp.compile_rollout_random(inp["sem"], inp["bl_walls"], W.B_ROLL, W.T_ROLL, W.MAX_EP)(11)
    for f in ("agent_idx", "agent_code", "t"):
        np.testing.assert_array_equal(sharded_run["rollout"][f], getattr(state, f).numpy())
    assert int(sharded_run["stats"]["episodes"]) == int(stats["episodes"]) > 0
    assert float(sharded_run["stats"]["mean_length"]) == float(stats["mean_length"])


def test_peer_loss_fails_survivor_collective(tmp_path):
    """Rank 1 is SIGKILLed after one collective; rank 0's next collective
    raises (a Gloo error or the group's 20 s timeout) instead of hanging."""
    out = tmp_path / "survivor.txt"
    port = W.free_port()
    procs = [_spawn("peer_loss", r, 2, port, out) for r in range(2)]
    (code0, err0), (code1, _) = _wait_all(procs)
    assert code1 == -signal.SIGKILL
    assert code0 == 0, err0[-2000:]
    seen = out.read_text()
    assert seen.startswith("RAISED"), seen
    assert float(seen.split()[1]) < 60.0, seen


def _resume_drill(tmp_path, engine, crash_after):
    ckpt = str(tmp_path / f"ckpt_{engine}")
    cmd = [sys.executable, "-m", "tests.torch_parallel_worker", "resume", engine, ckpt]
    p1 = subprocess.run(cmd, cwd=REPO, env=_env(GU_CRASH_AFTER_CHUNK=str(crash_after)),
                        capture_output=True, text=True, timeout=PROCESS_TIMEOUT_S)
    assert p1.returncode == -signal.SIGKILL, (p1.returncode, p1.stderr[-500:])
    assert "COMPLETED" not in p1.stdout
    p2 = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=PROCESS_TIMEOUT_S)
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert f"COMPLETED {W.DRILL_CHUNKS * W.DRILL_CHUNK_STEPS}" in p2.stdout

    template, run = W.drill_engine(engine)
    ts = template
    for _ in range(W.DRILL_CHUNKS):
        ts = run(ts)
    step, recovered = CheckpointManager(ckpt).restore_latest(W.drill_engine(engine)[0])
    assert step == W.DRILL_CHUNKS
    got, want = flatten(recovered), flatten(ts)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("crash_after", [1, 2])
def test_sigkill_recovery_is_bitexact(tmp_path, crash_after):
    _resume_drill(tmp_path, "td", crash_after)


def test_sigkill_recovery_fast_engine_is_bitexact(tmp_path):
    _resume_drill(tmp_path, "fast", 2)
