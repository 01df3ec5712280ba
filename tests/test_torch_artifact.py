"""The committed GENERALIZATION_TORCH.json, the port's generalization gate
as measured on the card, must stay coherent: the reference's schema, the
four configs, enough seeds, the 256-maze held-out set, the min and max
taken over the runs, and the card it ran on. It trains nothing. It keeps a
partial regeneration from dropping a config (`--configs 7x7_*` writing the
file without the other rows). Whether the runs clear the reference's bar
is a finding reported in PERF.md, not asserted here."""

import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPECTED_CONFIGS = {"7x7_ch32", "7x7_ch16", "9x9_ch32x2", "11x11_curriculum"}
MIN_SEEDS = {"7x7_ch32": 3, "7x7_ch16": 3, "9x9_ch32x2": 3, "11x11_curriculum": 1}
# each config's full recipe: updates (a chunk), fresh-maze chunks
FULL_RECIPE = {"7x7_ch32": (1500, None), "7x7_ch16": (1500, None), "9x9_ch32x2": (4000, None),
               "11x11_curriculum": (500, 32)}
RUN_KEYS = {"seed", "train_success", "heldout_success", "wrong_tiles_ablation", "train_wall_s"}


def _artifact():
    with open(os.path.join(REPO, "GENERALIZATION_TORCH.json")) as f:
        return json.load(f)


def _configs():
    return {c["name"]: c for c in _artifact()["configs"]}


def test_artifact_schema_and_configs():
    art = _artifact()
    assert art["metric"] == "ppo_mazes_generalization_frontier"
    assert set(_configs()) == EXPECTED_CONFIGS
    assert len(art["configs"]) == len(EXPECTED_CONFIGS)


def test_artifact_names_the_card_and_its_power_limit():
    # as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives it
    assert re.fullmatch(r"NVIDIA .+, \d+(\.\d+)? W", _artifact()["device"])


@pytest.mark.parametrize("name", sorted(EXPECTED_CONFIGS))
def test_artifact_config_is_coherent(name):
    cfg = _configs()[name]
    runs = cfg["runs"]
    assert len(runs) >= MIN_SEEDS[name], f"{name}: fewer than {MIN_SEEDS[name]} seeds"
    assert len({r["seed"] for r in runs}) == len(runs), f"{name}: a seed twice"
    assert all(set(r) == RUN_KEYS for r in runs)
    assert cfg["recipe"]["eval_mazes"] >= 256, f"{name}: coarse eval"
    assert cfg["recipe"]["mazes"] == 1024 and cfg["recipe"]["algorithm"] == "aldous_broder"
    updates, chunks = FULL_RECIPE[name]
    assert cfg["recipe"]["updates"] == updates and cfg["recipe"].get("fresh_maze_chunks") == chunks
    assert cfg["recipe"]["greedy_budget_steps"] == 60
    assert cfg["heldout_min"] == min(r["heldout_success"] for r in runs)
    assert cfg["ablation_max"] == max(r["wrong_tiles_ablation"] for r in runs)
    for r in runs:
        for key in ("train_success", "heldout_success", "wrong_tiles_ablation"):
            assert 0.0 <= r[key] <= 1.0
        assert r["train_wall_s"] > 0
