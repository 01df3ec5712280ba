"""Example 12 — long-run DISTRIBUTED training with checkpoint/resume.

The resumable sharded path end to end: `ppo_init_sharded` builds each
rank's part of the train state (parameters and Adam replicated, envs and
per-shard statistics sharded), `ppo_run_sharded` advances it in chunks,
and a `CheckpointManager` a rank persists every chunk. Kill the script at
any point and rerun it: the ranks agree on the latest chunk every one of
them saved, restore it and continue (the per-update draws come from
(seed, shard, update) alone, so the chunked run equals an unbroken one
bit for bit). A kill mid-chunk replays that chunk. Saves run in the
background (`async_=True`): the loop pays only the host snapshot at the
chunk boundary.

The script starts its ranks itself: one a card over NCCL on the card,
two Gloo ranks on the CPU.

    python examples_torch/12_sharded_checkpoint_resume.py
    # ... ctrl-C mid-run, then run the same command again: it resumes
"""

from __future__ import annotations

import time

from _common import default_ranks, parse_args, run_ranks


def rank_main(rank, world, dev, envs, chunks, updates_per_chunk, ckpt_dir):
    import os

    import torch

    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu_torch.models import PPOConfig, ppo_init_sharded, ppo_run_sharded
    from griduniverse_tpu_torch.parallel import make_env_mesh
    from griduniverse_tpu_torch.parallel.mesh import all_reduce_max, all_reduce_sum
    from griduniverse_tpu_torch.utils.checkpoint import CheckpointManager, restore_checkpoint

    sem = gu.make_semantics(device=dev)
    level = walls_and_goal_16x16(device=dev)
    mesh = make_env_mesh(device=dev)
    cfg = PPOConfig(
        rollout_len=8, num_epochs=2, num_minibatches=2,
        hidden=(32,), embed_dim=8, max_episode_steps=64,
        compute_dtype="float32",
    )

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    # the template also gives the restored state's layout and device
    ts = ppo_init_sharded(mesh, sem, level, 0, cfg, batch_size=envs)
    with CheckpointManager(os.path.join(ckpt_dir, f"rank{rank}"), max_to_keep=2, async_=True) as mgr:
        mine = mgr.steps()
        # the latest update every rank saved (a kill may cut one rank's last write)
        latest = -int(all_reduce_max(mesh, torch.tensor([-(mine[-1] if mine else 0)], device=dev)))
        if latest:
            ts = restore_checkpoint(os.path.join(mgr.directory, f"step_{latest:012d}"), ts)
            say(f"resumed from checkpoint at update {latest}")

        while int(ts.update) < chunks * updates_per_chunk:
            t0 = time.perf_counter()
            ts = ppo_run_sharded(mesh, sem, level, ts, cfg, num_updates=updates_per_chunk)
            episodes = int(all_reduce_sum(mesh, ts.episodes.reshape(1)))
            ret_sum = float(all_reduce_sum(mesh, ts.ret_sum.reshape(1)))
            t_save = time.perf_counter()
            mgr.save(int(ts.update), ts)  # background write
            t_save = time.perf_counter() - t_save
            say(
                f"update {int(ts.update):4d}: episodes {episodes:6d} "
                f"mean_return {ret_sum / max(episodes, 1):7.2f} "
                f"({time.perf_counter() - t0:.1f}s/chunk, save scheduled in {t_save * 1e3:.0f}ms)"
            )
        # the context's exit joins the last background write
    say(f"done — {int(ts.update)} updates, state in {ckpt_dir}")


def main():
    args = parse_args(
        "Chunked, checkpointed, sharded PPO training",
        envs=(int, 512, "total env batch (sharded over the ranks)"),
        chunks=(int, 5, "number of training chunks"),
        updates_per_chunk=(int, 20, "PPO updates per chunk"),
        ckpt_dir=(str, "/tmp/griduniverse_torch_ckpt_example", "checkpoint dir"),
        fresh=(int, 0, "1 = wipe the checkpoint dir first (no resume)"),
        ranks=(int, 0, "ranks (0: every card, or two on the CPU)"),
    )
    if args.fresh:
        import shutil

        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    run_ranks(rank_main, args.ranks or default_ranks(args.device), args.device, args.envs,
              args.chunks, args.updates_per_chunk, args.ckpt_dir)


if __name__ == "__main__":
    main()
