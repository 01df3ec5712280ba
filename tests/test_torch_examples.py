"""Smoke tests of the port's examples: every `examples_torch/` script runs
end to end on the CPU with tiny arguments, each in a subprocess of its own
(`--device cpu`: the kernels' plain versions). The sharded ones (05, 09,
12) start two Gloo ranks."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples_torch"

# script → tiny arguments (every script takes --device cpu)
TINY_ARGS = {
    "01_gym_style_random_walk.py": ["--steps", "5"],
    "02_value_iteration.py": [],
    "03_q_learning_vectorized.py": ["--envs", "64", "--steps", "200"],
    "04_procedural_mazes.py": ["--envs", "16", "--cells", "3", "--steps", "64"],
    "05_multihost_sharded.py": ["--envs", "64", "--steps", "100", "--ranks", "2"],
    "06_fast_engine.py": ["--envs", "64", "--steps", "500", "--train_steps", "200"],
    "07_ppo.py": ["--updates", "3", "--envs", "16"],
    "08_dqn.py": ["--steps", "150", "--envs", "16"],
    "09_multiprocess.py": ["--procs", "2", "--steps", "100", "--envs", "64"],
    "10_traces_per_gridobs.py": [
        "--envs", "16", "--td_steps", "300", "--dqn_steps", "150", "--ppo_updates", "3",
    ],
    "11_maze_generalization.py": [
        "--mazes", "32", "--eval_mazes", "8", "--updates", "3", "--channels", "8", "--hidden", "16",
    ],
    "12_sharded_checkpoint_resume.py": [
        "--envs", "16", "--chunks", "2", "--updates_per_chunk", "2", "--fresh", "1",
    ],
    "13_fresh_maze_curriculum.py": [
        "--mazes", "32", "--eval_mazes", "8", "--chunks", "2", "--updates_per_chunk", "2",
        "--channels", "8", "--hidden", "16",
    ],
}


def test_every_example_has_tiny_args():
    found = sorted(p.name for p in EXAMPLES.glob("[0-9]*.py"))
    assert found == sorted(TINY_ARGS), f"examples_torch/ and TINY_ARGS disagree: {found}"


def test_examples_import_no_jax_and_not_the_reference():
    files = sorted(EXAMPLES.glob("*.py"))
    assert len(files) == len(TINY_ARGS) + 1  # and _common.py
    for f in files:
        roots = set()
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "flax", "optax", "griduniverse_tpu"}, f.name
        assert "griduniverse_tpu_torch" in roots or f.name == "_common.py", f.name


@pytest.mark.parametrize("script", sorted(TINY_ARGS))
def test_example_runs(script, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the suite's workers share the CPU
    args = list(TINY_ARGS[script])
    if script.startswith("12_"):
        args += ["--ckpt_dir", str(tmp_path / "ckpt")]
    proc = subprocess.run(
        [sys.executable, script, "--device", "cpu", *args],
        cwd=EXAMPLES, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-2000:]}\n--- stderr ---\n{proc.stderr[-2000:]}"
    )
