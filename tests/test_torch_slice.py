"""The port's main path end to end against the JAX path, and its imports.

level → pack_level → random-action scan (K1's plain version on the CPU) →
episode stats, on walls16 and on per-env Aldous–Broder mazes (generated by
K3's plain version from the reference's injected draws). Final states and
per-env accumulators are bit-exact; cross-env means agree to rtol=1e-6.
"""

from __future__ import annotations

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.levels import maze as jm
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tm
from griduniverse_tpu_torch.ops import bitplane as tbp

torch.set_num_threads(1)
CPU = torch.device("cpu")

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "griduniverse_tpu"}


def _slice_levels(name):
    if name == "walls16":
        return jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU), 512
    b, cells, max_iters = 256, (4, 4), 2000
    key = jax.random.PRNGKey(12)
    grids_j = jm._aldous_broder_mazes(key, cells, b, max_iters=max_iters)
    draw = jax.vmap(lambda t: jax.random.randint(jax.random.fold_in(key, t), (b,), 0, 4, jnp.int32))
    dirs = torch.as_tensor(np.array(draw(jnp.arange(max_iters))).astype(np.int8))
    grids_t = tm._aldous_broder_mazes(cells, b, max_iters, directions=dirs)
    start = 2 * cells[1] + 2
    jl = JLevel(grid=grids_j, start_idx=jnp.full((b,), start, jnp.int32))
    return jl, T.make_level(grids_t.numpy(), start, device=CPU), b


@pytest.mark.parametrize("name", ["walls16", "ab_mazes"])
def test_slice_matches_jax(name):
    jl, tl, b = _slice_levels(name)
    np.testing.assert_array_equal(np.asarray(jl.grid), tl.grid.numpy())
    steps, max_ep = 400, 100
    jfn = jbp.compile_rollout_random(J.make_semantics(), jbp.pack_level(jl), b, steps, max_ep)
    jstate, jstats = jfn(jnp.uint32(3))
    tfn = tbp.compile_rollout_random(T.make_semantics(device=CPU), tbp.pack_level(tl), b, steps, max_ep)
    tstate, tstats = tfn(3)
    for f in ("agent_idx", "agent_code", "t", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(jstate, f)), getattr(tstate, f).numpy())
    assert int(tstats["episodes"]) == int(jstats["episodes"]) > 0
    for k in ("mean_return", "mean_length"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-6)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_not_the_reference():
    files = sorted((ROOT / "griduniverse_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert not {f: r for f, r in bad.items() if r}
    # the scan sees imports written inside functions too
    probe = ROOT / "griduniverse_tpu_torch" / "ops" / "bitplane.py"
    assert "torch" in _imported_roots(probe)
