"""The generalization gate on the card: one conv-trunk PPO agent trained
across distinct on-device mazes, measured at four points (7×7 at conv
widths 32 and 16, 9×9, and an 11×11 fresh-maze curriculum), each with the
wrong-tiles ablation control on a 256-maze held-out set, written to
`GENERALIZATION_TORCH.json` at the repo root.

Counterpart of `tools/gen_artifact.py`, with the same four recipes, flags
(plus `--device`) and JSON schema. The mazes are K3's Aldous–Broder mazes;
every update runs K7b (T launches), K7a (one) and K9b (each forward and
backward of the per-env conv trunk); the greedy evaluations run K7b's
greedy form. The keys of the reference become integer seeds:

  PRNGKey(0), the training mazes           → seed 0 (`TRAIN_MAZES_SEED`)
  PRNGKey(99), the held-out mazes          → seed 99 (`EVAL_MAZES_SEED`)
  PRNGKey(seed), a fixed-set run           → seed `seed`
  fold_in(PRNGKey(seed), chunk)            → `chunk_maze_seed(seed, chunk)`
  fold_in(PRNGKey(1000 + seed), chunk)     → `chunk_state_seed(seed, chunk)`

The fresh-maze curriculum lives here alone (`curriculum_train`); the
probe `tools/fresh_maze_curriculum.py` and the examples call it.

Run on the card (`--device cpu` only when asked):
    python -m griduniverse_tpu_torch.tools.gen_artifact                       # every config, seeds 1-5
    python -m griduniverse_tpu_torch.tools.gen_artifact --configs 7x7_ch32 --seeds 1 2 3
    python -m griduniverse_tpu_torch.tools.gen_artifact --updates 50 --mazes 128 --configs 7x7_ch32 --out /tmp/g.json

Several runs at once: one process a (config, seed), each to its own
`--out`, then one artifact from their files:
    for s in 1 2 3; do
      python -m griduniverse_tpu_torch.tools.gen_artifact --configs 9x9_ch32x2 --seeds $s --out parts/9x9_$s.json &
    done; wait
    python -m griduniverse_tpu_torch.tools.gen_artifact --merge parts/*.json
Processes on one card share its time, so a run's `train_wall_s` holds the
load it ran under: compare it only between runs made under the same load.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch

from .. import make_semantics
from ..core import semantics as S
from ..core.types import Level
from ..levels.maze import generate_mazes_device
from ..models import PPOConfig, greedy_success_rate, make_network, ppo_init, ppo_run, ppo_train
from ..models.a2c import mix_seed
from ..utils.platform import resolve_device

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "GENERALIZATION_TORCH.json"
METRIC = "ppo_mazes_generalization_frontier"
TRAIN_MAZES_SEED = 0
EVAL_MAZES_SEED = 99

# The frontier: name -> (cells, conv_channels, updates, ent, lr_schedule),
# the reference's four recipes unchanged. The 11×11 row regenerates its
# 1,024 training mazes every 500-update chunk (fresh_maze_chunks), carrying
# the parameters and the Adam state across each swap.
CONFIGS = {
    "7x7_ch32": dict(cells=3, ch=(32,), updates=1500, ent=0.03,
                     lr_schedule="constant", budget=60),
    "7x7_ch16": dict(cells=3, ch=(16,), updates=1500, ent=0.03,
                     lr_schedule="constant", budget=60),
    "9x9_ch32x2": dict(cells=4, ch=(32, 32), updates=4000, ent=0.05,
                       lr_schedule="linear", budget=60),
    "11x11_curriculum": dict(cells=5, ch=(32, 32), updates=500, ent=0.05,
                             lr_schedule="linear", budget=60,
                             fresh_maze_chunks=32),
}


def chunk_maze_seed(seed: int, chunk: int) -> int:
    """The seed of chunk `chunk`'s training mazes (the reference's
    `fold_in(PRNGKey(seed), chunk)`)."""
    return mix_seed(seed, chunk)


def chunk_state_seed(seed: int, chunk: int) -> int:
    """The seed of chunk `chunk`'s train state (the reference's
    `fold_in(PRNGKey(1000 + seed), chunk)`)."""
    return mix_seed(1000 + seed, chunk)


def goal_levels(grids: torch.Tensor, start: torch.Tensor) -> Level:
    """Mazes (N, H, W) as a batched Level: the goal at (H−2, W−2), every
    maze starting at `start`."""
    n, h, w = grids.shape
    grids = grids.clone()
    grids[:, h - 2, w - 2] = S.GOAL
    return Level(grid=grids, start_idx=start.to(torch.int32).expand(n).contiguous())


def maze_levels(seed: int, n: int, cells, device=None) -> Level:
    """N Aldous–Broder mazes (K3 on the card) from an integer seed, as
    `goal_levels`."""
    grids, start = generate_mazes_device(seed, tuple(cells), n, algorithm="aldous_broder",
                                         device=resolve_device(device))
    return goal_levels(grids, start)


def rolled_tiles_level(levels: Level) -> Level:
    """The wrong-tiles ablation: env b keeps its maze's dynamics but the
    network sees maze b+1's planes (the `tiles_levels` argument of
    `models.evaluation.greedy_success_rate`)."""
    return Level(grid=torch.roll(levels.grid, 1, dims=0), start_idx=levels.start_idx)


def curriculum_train(sem, cfg: PPOConfig, seed: int, chunks: int, updates_per_chunk: int,
                     mazes: int, cells, device=None, *, levels=None, init=None, draws=None):
    """Fresh-maze curriculum: regenerate the training set every chunk and
    carry the parameters and the Adam state (the lr schedule's count
    included) across the level swap. Each chunk's `ppo_init` starts its
    update counter at 0 on `chunk_state_seed(seed, chunk)`, so a chunk's
    draws follow (chunk seed, update) while its rates follow the carried
    count. Returns (the last chunk's train state, its levels).

    For a comparison with the reference: `levels` (one Level a chunk)
    replaces the chunks' mazes, `init` = (params, opt_state) chunk 0's
    initial ones, and `draws` (one (gumbel, shuffle_draws) a chunk) the
    draws `ppo_run` takes."""
    ts = lv = None
    for chunk in range(chunks):
        lv = levels[chunk] if levels is not None else maze_levels(
            chunk_maze_seed(seed, chunk), mazes, cells, device)
        fresh = ppo_init(sem, lv, chunk_state_seed(seed, chunk), cfg, batch_size=mazes)
        carried = init if ts is None else (ts.params, ts.opt_state)
        if carried is not None:
            fresh = dataclasses.replace(fresh, params=carried[0], opt_state=carried[1])
        gumbel, shuffle = (None, None) if draws is None else draws[chunk]
        ts = ppo_run(sem, lv, fresh, cfg, updates_per_chunk, gumbel=gumbel, shuffle_draws=shuffle)
    return ts, lv


def gate_config(spec: dict, updates: int) -> PPOConfig:
    """The PPO recipe of one config at `updates` updates a chunk."""
    return PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=spec["ch"], hidden=(64,),
        num_epochs=4, num_minibatches=4,
        lr=1e-3, lr_schedule=spec["lr_schedule"],
        lr_decay_updates=updates * (spec.get("fresh_maze_chunks") or 1),
        ent_coef=spec["ent"], gamma=0.97,
        compute_dtype="float32",
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_config(name, spec, mazes, eval_mazes, seeds, updates_override=None, device=None):
    """Train and score one config at each seed; the artifact's entry."""
    device = resolve_device(device)
    sem = make_semantics(device=device)
    cells = (spec["cells"], spec["cells"])
    updates = updates_override or spec["updates"]
    chunks = spec.get("fresh_maze_chunks")
    train_lv = maze_levels(TRAIN_MAZES_SEED, mazes, cells, device)
    eval_lv = maze_levels(EVAL_MAZES_SEED, eval_mazes, cells, device)
    abl_lv = rolled_tiles_level(eval_lv)
    cfg = gate_config(spec, updates)
    net = make_network(train_lv, sem.num_actions, cfg)
    budget = spec["budget"]

    runs = []
    for seed in seeds:
        _sync(device)
        t0 = time.perf_counter()
        if chunks:
            ts, train_eval_lv = curriculum_train(sem, cfg, seed, chunks, updates, mazes, cells, device)
            params = ts.params  # train score = the last chunk's mazes
        else:
            params = ppo_train(sem, train_lv, seed, cfg, num_updates=updates, batch_size=mazes).params
            train_eval_lv = train_lv
        _sync(device)
        wall = time.perf_counter() - t0
        train_s = float(greedy_success_rate(sem, net, params, train_eval_lv, budget))
        held_s = float(greedy_success_rate(sem, net, params, eval_lv, budget))
        abl_s = float(greedy_success_rate(sem, net, params, eval_lv, budget, tiles_levels=abl_lv))
        runs.append({
            "seed": seed,
            "train_success": round(train_s, 4),
            "heldout_success": round(held_s, 4),
            "wrong_tiles_ablation": round(abl_s, 4),
            "train_wall_s": round(wall, 1),
        })
        print(f"{name} seed {seed}: train {train_s:.3f} held-out {held_s:.3f} "
              f"ablation {abl_s:.3f} ({wall:.0f}s)", flush=True)

    grid = 2 * spec["cells"] + 1
    return {
        "name": name,
        "recipe": {
            "mazes": mazes, "eval_mazes": eval_mazes,
            "grid": f"{grid}x{grid}",
            "algorithm": "aldous_broder", "updates": updates,
            "rollout_len": cfg.rollout_len,
            "max_episode_steps": cfg.max_episode_steps,
            "gamma": cfg.gamma, "lr": cfg.lr,
            "lr_schedule": cfg.lr_schedule, "ent_coef": cfg.ent_coef,
            "conv_channels": list(cfg.conv_channels),
            "hidden": list(cfg.hidden),
            "greedy_budget_steps": budget,
            **({"fresh_maze_chunks": chunks, "updates_total": updates * chunks} if chunks else {}),
        },
        "runs": runs,
        "heldout_min": min(r["heldout_success"] for r in runs),
        "ablation_max": max(r["wrong_tiles_ablation"] for r in runs),
    }


def device_name(device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them, or the
    device's type off the card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def merge(artifacts: list[dict]) -> dict:
    """One artifact from several: each config's runs gathered in seed
    order, its min and max taken anew. The parts must agree on the device,
    the metric and each config's recipe."""
    devices = {a["device"] for a in artifacts}
    if len(devices) != 1 or {a["metric"] for a in artifacts} != {METRIC}:
        raise ValueError(f"parts from different devices or metrics: {sorted(devices)}")
    by_name: dict[str, dict] = {}
    for part in artifacts:
        for c in part["configs"]:
            have = by_name.setdefault(c["name"], {"name": c["name"], "recipe": c["recipe"], "runs": []})
            if have["recipe"] != c["recipe"]:
                raise ValueError(f"{c['name']}: the parts' recipes differ")
            have["runs"].extend(c["runs"])
    unknown = set(by_name) - set(CONFIGS)
    if unknown:
        raise ValueError(f"configs not in CONFIGS: {sorted(unknown)}")
    configs = []
    for name in (n for n in CONFIGS if n in by_name):
        c = by_name[name]
        runs = sorted(c["runs"], key=lambda r: r["seed"])
        seeds = [r["seed"] for r in runs]
        if len(set(seeds)) != len(seeds):
            raise ValueError(f"{name}: a seed appears twice: {seeds}")
        configs.append({**c, "runs": runs,
                        "heldout_min": min(r["heldout_success"] for r in runs),
                        "ablation_max": max(r["wrong_tiles_ablation"] for r in runs)})
    return {"metric": METRIC, "device": devices.pop(), "configs": configs}


def _write(artifact: dict, out) -> None:
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {out}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mazes", type=int, default=1024)
    ap.add_argument("--eval_mazes", type=int, default=256)
    ap.add_argument("--updates", type=int, default=None,
                    help="override per-config updates (smoke runs)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--out", default=None, help=f"default {DEFAULT_OUT.name} at the repo root")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--merge", nargs="+", default=None, metavar="JSON",
                    help="merge these artifacts' runs into --out and train nothing")
    args = ap.parse_args(argv)
    out = args.out or DEFAULT_OUT

    if args.merge:
        parts = []
        for path in args.merge:
            with open(path) as f:
                parts.append(json.load(f))
        artifact = merge(parts)
    else:
        artifact = {
            "metric": METRIC,
            "device": device_name(args.device),
            "configs": [
                run_config(name, CONFIGS[name], args.mazes, args.eval_mazes, args.seeds,
                           args.updates, args.device)
                for name in args.configs
            ],
        }
    _write(artifact, out)


if __name__ == "__main__":
    main()
