"""Port parity: the generalization gate's tool (`tools/gen_artifact.py`) and
the fresh-maze curriculum against the reference's, on the CPU.

The reference's tool is loaded from its file (`tools/` is not a package).
Its levels are rebuilt from the reference's K3 grids bit for bit; its
curriculum over 2 chunks × 2 updates is repeated by the port's with the
reference's per-chunk mazes, its chunk-0 parameters and Adam state, and
each chunk's Gumbel and shuffle draws injected, in float32 at 7×7 with 32
mazes, conv (8,) and hidden (16,): the parameters agree to atol 1e-5. The
Adam count is carried across chunks, so the lr schedule runs on unbroken;
`run_config` builds the reference's recipe; the tool's output keeps the
reference's schema.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import models as jm
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.levels.maze import generate_mazes_device as jax_mazes
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.levels import maze as tmaze
from griduniverse_tpu_torch.models import ppo as tppo
from griduniverse_tpu_torch.tools import fresh_maze_curriculum as tfresh
from griduniverse_tpu_torch.tools import gen_artifact as tg
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _load_reference_tool():
    spec = importlib.util.spec_from_file_location("reference_gen_artifact", REPO / "tools" / "gen_artifact.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference_tool()
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)

# the tiny recipe: 7×7, 32 mazes, 8 held out, conv (8,), hidden (16,), float32
CELLS, MAZES, EVAL_MAZES = (3, 3), 32, 8
CHUNKS, UPDATES = 2, 2
TINY = dict(
    rollout_len=16, max_episode_steps=48, obs="grid", conv_channels=(8,), hidden=(16,),
    num_epochs=4, num_minibatches=4, lr=1e-3, lr_schedule="linear",
    lr_decay_updates=UPDATES * CHUNKS, ent_coef=0.05, gamma=0.97, compute_dtype="float32",
)


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_draws(base_key, update, cfg, batch, num_actions=4):
    """The draws the reference's PPO update `update` makes from `base_key`
    ("roll" shuffles)."""
    key_roll, key_perm = jax.random.split(jax.random.fold_in(base_key, update))
    gumbel = jax.random.gumbel(key_roll, (cfg.rollout_len, batch, num_actions))
    rolls = [jax.random.randint(k, (), 0, batch) for k in jax.random.split(key_perm, cfg.num_epochs)]
    return torch.as_tensor(np.array(gumbel)), [torch.as_tensor(np.array(r)).long() for r in rolls]


@pytest.mark.parametrize("seed,cells,n", [(0, (3, 3), 32), (99, (4, 4), 8), (7, (5, 5), 16), (3, (3, 5), 4)])
def test_levels_from_the_reference_grids_are_the_reference_levels(seed, cells, n):
    key = jax.random.PRNGKey(seed)
    ref = REF.maze_levels(key, n, cells)
    grids, start = jax_mazes(key, cells, n, algorithm="aldous_broder")
    got = tg.goal_levels(torch.as_tensor(np.array(grids)), torch.as_tensor(np.array(start)))
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(ref.grid))
    np.testing.assert_array_equal(got.start_idx.numpy(), np.asarray(ref.start_idx))
    assert got.grid.dtype == torch.int32 and got.start_idx.dtype == torch.int32
    abl, ref_abl = tg.rolled_tiles_level(got), REF.rolled_tiles_level(ref)
    np.testing.assert_array_equal(abl.grid.numpy(), np.asarray(ref_abl.grid))
    np.testing.assert_array_equal(abl.start_idx.numpy(), np.asarray(ref_abl.start_idx))


@pytest.mark.parametrize("cells", [(3, 3), (4, 4), (5, 5)])
def test_maze_levels_are_k3_mazes_with_the_goal(cells):
    lv = tg.maze_levels(5, 16, cells, CPU)
    grids, start = tmaze.generate_mazes_device(5, cells, 16, "aldous_broder", device=CPU)
    h, w = grids.shape[1:]
    assert torch.equal(lv.grid[:, : h - 2], grids[:, : h - 2]) and int(start) == w + 1
    assert (lv.grid[:, h - 2, w - 2] == T.GOAL).all() and (lv.start_idx == w + 1).all()
    assert all(tmaze.check_perfect_maze(g, cells) for g in lv.grid)
    assert torch.equal(tg.maze_levels(5, 16, cells, CPU).grid, lv.grid)
    assert not torch.equal(tg.maze_levels(6, 16, cells, CPU).grid, lv.grid)


def test_seed_mapping_keeps_every_stream_apart():
    seeds = [tg.TRAIN_MAZES_SEED, tg.EVAL_MAZES_SEED]
    for s in (1, 2, 3):
        seeds += [tg.chunk_maze_seed(s, c) for c in range(32)] + [tg.chunk_state_seed(s, c) for c in range(32)]
    assert len(set(seeds)) == len(seeds)
    # K3 keys a walk's stream by the seed's low 32 bits
    assert len({s & 0xFFFFFFFF for s in seeds}) == len(seeds)


def _reference_chunks(seed):
    """The reference's per-chunk levels and chunk-0 train state, and the
    port's injections made of them."""
    jcfg = jm.PPOConfig(**TINY)
    levels, draws, jts0 = [], [], None
    for chunk in range(CHUNKS):
        jlv = REF.maze_levels(jax.random.fold_in(jax.random.PRNGKey(seed), chunk), MAZES, CELLS)
        jts = jm.ppo_init(JSEM, jlv, jax.random.fold_in(jax.random.PRNGKey(1000 + seed), chunk), jcfg,
                          batch_size=MAZES)
        jts0 = jts if jts0 is None else jts0
        one = [jax_draws(jts.key, u, jcfg, MAZES) for u in range(UPDATES)]
        draws.append((torch.stack([g for g, _ in one]), [d for _, d in one]))
        levels.append(convert.to_level(jlv, device=CPU))
    return jcfg, levels, draws, jts0


@pytest.mark.parametrize("seed", [1, 2])
def test_curriculum_matches_the_reference(seed):
    jcfg, levels, draws, jts0 = _reference_chunks(seed)
    jparams, jlv = REF._curriculum_train(JSEM, jcfg, seed, CHUNKS, UPDATES, MAZES, CELLS)

    tcfg = tm.PPOConfig(**TINY)
    tnet = tm.make_network(levels[0], 4, tcfg)
    init = (convert.to_network_state(tree_np(jts0.params), tnet), convert.to_adam_state(tree_np(jts0.opt_state), tnet))
    ts, lv = tg.curriculum_train(TSEM, tcfg, seed, CHUNKS, UPDATES, MAZES, CELLS, CPU,
                                 levels=levels, init=init, draws=draws)
    np.testing.assert_array_equal(lv.grid.numpy(), np.asarray(jlv.grid))
    want = convert.to_network_state(tree_np(jparams), tnet)
    assert set(want) == set(ts.params)
    for name in want:
        np.testing.assert_allclose(ts.params[name].numpy(), want[name].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert int(ts.opt_state.count) == CHUNKS * UPDATES * 16
    assert ts.update == UPDATES  # each chunk's counter starts at 0


def test_adam_count_and_rate_carry_across_chunks(monkeypatch):
    """After chunk c the Adam count is c × updates × 4 × 4, and every
    rate, chunk 1's first included, is the unbroken linear schedule's."""
    seen = []
    make_rate = tppo._rate

    def recording(cfg):
        rate = make_rate(cfg)

        def rate_of(count):
            seen.append((int(count), rate(count)))
            return seen[-1][1]

        return rate_of

    monkeypatch.setattr(tppo, "_rate", recording)
    cfg = tm.PPOConfig(**TINY)
    for chunks in (1, 2):
        seen.clear()
        ts, _ = tg.curriculum_train(TSEM, cfg, 4, chunks, UPDATES, MAZES, CELLS, CPU)
        steps = chunks * UPDATES * cfg.num_epochs * cfg.num_minibatches
        assert int(ts.opt_state.count) == steps
        assert [c for c, _ in seen] == list(range(steps))
    unbroken = make_rate(cfg)  # the schedule of one run over every chunk
    per_update = cfg.num_epochs * cfg.num_minibatches
    first_of_chunk1 = seen[UPDATES * per_update]
    assert first_of_chunk1[0] == UPDATES * per_update
    for count, rate in seen:
        assert torch.equal(rate, unbroken(torch.tensor(count, dtype=torch.int32)))
    lr, total = cfg.lr, cfg.lr_decay_updates * per_update
    np.testing.assert_allclose(float(first_of_chunk1[1]), lr * (1 - first_of_chunk1[0] / total), rtol=1e-6)


class _Stub:
    """Stand-ins for training and scoring: `run_config`'s recipe and schema
    without a run. Records the PPO configs it is handed."""

    def __init__(self, level_of):
        self.cfgs, self.level_of = [], level_of

    def maze_levels(self, key, n, cells, *rest):
        return self.level_of(n, cells)

    def ppo_train(self, sem, level, key, cfg, num_updates, batch_size):
        self.cfgs.append(cfg)
        return type("R", (), {"params": None, "final_loss": 0.0})()

    def curriculum(self, sem, cfg, seed, chunks, updates, mazes, cells, *rest):
        self.cfgs.append(cfg)
        return self.result(), self.level_of(mazes, cells)

    def result(self):
        return None

    @staticmethod
    def greedy_success_rate(sem, net, params, levels, budget, tiles_levels=None):
        return 0.5 if tiles_levels is None else 0.125


@pytest.mark.parametrize("name", list(REF.CONFIGS))
@pytest.mark.parametrize("mazes,eval_mazes,updates", [(1024, 256, None), (64, 16, 7)])
def test_run_config_builds_the_reference_recipe(monkeypatch, name, mazes, eval_mazes, updates):
    assert tg.CONFIGS[name] == REF.CONFIGS[name]
    ref_stub = _Stub(lambda n, c: JLevel(
        grid=jax.numpy.zeros((n, 2 * c[0] + 1, 2 * c[1] + 1), jax.numpy.int32),
        start_idx=jax.numpy.zeros((n,), jax.numpy.int32)))
    ref_stub.result = lambda: None
    monkeypatch.setattr(REF, "maze_levels", ref_stub.maze_levels)
    monkeypatch.setattr(REF, "ppo_train", ref_stub.ppo_train)
    monkeypatch.setattr(REF, "_curriculum_train", ref_stub.curriculum)
    monkeypatch.setattr(REF, "greedy_success_rate", ref_stub.greedy_success_rate)
    port_stub = _Stub(lambda n, c: T.Level(
        grid=torch.zeros((n, 2 * c[0] + 1, 2 * c[1] + 1), dtype=torch.int32),
        start_idx=torch.zeros((n,), dtype=torch.int32)))
    port_stub.result = lambda: type("S", (), {"params": None})()
    monkeypatch.setattr(tg, "maze_levels", port_stub.maze_levels)
    monkeypatch.setattr(tg, "ppo_train", port_stub.ppo_train)
    monkeypatch.setattr(tg, "curriculum_train", port_stub.curriculum)
    monkeypatch.setattr(tg, "greedy_success_rate", port_stub.greedy_success_rate)

    want = REF.run_config(name, REF.CONFIGS[name], mazes, eval_mazes, [1, 2], updates)
    got = tg.run_config(name, tg.CONFIGS[name], mazes, eval_mazes, [1, 2], updates, device=CPU)
    assert got["name"] == want["name"] and got["recipe"] == want["recipe"]
    assert [set(r) for r in got["runs"]] == [set(r) for r in want["runs"]]
    strip = [{k: v for k, v in r.items() if k != "train_wall_s"} for r in got["runs"]]
    assert strip == [{k: v for k, v in r.items() if k != "train_wall_s"} for r in want["runs"]]
    assert (got["heldout_min"], got["ablation_max"]) == (want["heldout_min"], want["ablation_max"])
    jcfg, tcfg = dataclasses.asdict(ref_stub.cfgs[0]), dataclasses.asdict(port_stub.cfgs[0])
    shared = set(jcfg) & set(tcfg)
    assert {"lr_schedule", "lr_decay_updates", "conv_channels", "ent_coef", "compute_dtype"} <= shared
    assert {k: tcfg[k] for k in shared} == {k: jcfg[k] for k in shared}
    assert len(port_stub.cfgs) == len(ref_stub.cfgs) == 2


def _part(name, seeds, device="NVIDIA H100 80GB HBM3, 700.00 W", held=0.9):
    runs = [{"seed": s, "train_success": 1.0, "heldout_success": held + s / 100,
             "wrong_tiles_ablation": 0.1 - s / 100, "train_wall_s": 1.0} for s in seeds]
    return {"metric": tg.METRIC, "device": device,
            "configs": [{"name": name, "recipe": {"grid": "7x7"}, "runs": runs,
                         "heldout_min": 0.0, "ablation_max": 1.0}]}


def test_merge_gathers_the_runs_of_every_part():
    out = tg.merge([_part("9x9_ch32x2", [3]), _part("7x7_ch16", [2, 1]), _part("9x9_ch32x2", [1, 2])])
    assert [c["name"] for c in out["configs"]] == ["7x7_ch16", "9x9_ch32x2"]
    for c in out["configs"]:
        assert [r["seed"] for r in c["runs"]] == sorted(r["seed"] for r in c["runs"])
        assert c["heldout_min"] == min(r["heldout_success"] for r in c["runs"])
        assert c["ablation_max"] == max(r["wrong_tiles_ablation"] for r in c["runs"])


@pytest.mark.parametrize("parts", [
    [_part("7x7_ch16", [1]), _part("7x7_ch16", [1])],                    # a seed twice
    [_part("7x7_ch16", [1]), _part("7x7_ch32", [1], device="cpu")],     # two devices
    [_part("7x7_ch16", [1]), _part("13x13_curriculum", [1])],            # not a config of the tool
])
def test_merge_refuses_parts_that_do_not_fit(parts):
    with pytest.raises(ValueError):
        tg.merge(parts)


def test_the_tool_writes_the_reference_schema(tmp_path, capsys):
    out = tmp_path / "g.json"
    tg.main(["--configs", "7x7_ch16", "--updates", "1", "--mazes", "16", "--eval_mazes", "8",
             "--seeds", "1", "2", "--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert art["metric"] == "ppo_mazes_generalization_frontier" and art["device"] == "cpu"
    (cfg,) = art["configs"]
    assert cfg["name"] == "7x7_ch16" and [r["seed"] for r in cfg["runs"]] == [1, 2]
    assert set(cfg["runs"][0]) == {"seed", "train_success", "heldout_success", "wrong_tiles_ablation",
                                   "train_wall_s"}
    assert cfg["heldout_min"] == min(r["heldout_success"] for r in cfg["runs"])
    assert "7x7_ch16 seed 2: train" in capsys.readouterr().out
    merged = tmp_path / "m.json"
    tg.main(["--merge", str(out), "--out", str(merged)])
    assert json.loads(merged.read_text()) == art


def test_the_probe_prints_the_reference_lines(capsys):
    tfresh.main(["--cells", "3", "--mazes", "16", "--eval_mazes", "8", "--chunks", "2",
                 "--updates_per_chunk", "1", "--seeds", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== 7x7 fresh-maze curriculum: 2 chunks x 1 updates, 32 distinct training mazes total"
    assert lines[1].startswith("  seed 1: last-chunk-train ") and " heldout " in lines[1]
