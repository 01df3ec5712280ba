"""Example 1 — the reference-style user journey: construct a Gym-style
env, take random actions, render ASCII each step (a K2 launch a step on the
card).

    python examples_torch/01_gym_style_random_walk.py --steps 20
    python examples_torch/01_gym_style_random_walk.py --device cpu
"""

from _common import parse_args


def main():
    args = parse_args(
        "Gym-style random walk",
        steps=(int, 20, "number of random steps"),
        seed=(int, 0, "action-sampling seed"),
    )
    from griduniverse_tpu_torch.compat import GridUniverseEnv

    env = GridUniverseEnv(
        grid_shape=(6, 6), walls=[7, 8, 13], lava=[21], goal_states=[35],
        seed=args.seed, device=args.device,
    )
    obs = env.reset()
    total = 0.0
    for t in range(args.steps):
        action = env.action_space.sample()
        obs, reward, done, info = env.step(action)
        total += reward
        print(f"t={t} action={action} obs={obs} reward={reward} done={done}")
        env.render()
        print()
        if done:
            print(f"episode finished, return={total}")
            obs = env.reset()
            total = 0.0


if __name__ == "__main__":
    main()
