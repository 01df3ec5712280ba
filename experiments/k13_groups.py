"""K13's time at each group of episodes a block, on one CUDA card: the
measurement behind `kernels/mc_returns.py`'s MIN_GROUP and TARGET_BLOCKS.
A one-off experiment of the redesign, kept to reproduce its readings; it is
not part of the package.

    python -m experiments.k13_groups

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints the card's name and power limit (`nvidia-smi`), then, at T = 100
over B = 256 and 1,024 episodes (a round of `mc_control`, `mc_prediction`
at 1,024) on random rewards, episode lengths and ids, K13 with the
first-visit mask (`mc_returns_cuda`) at each group from 32 episodes a block
down to 1: `plan` run with MAX_GROUP set to the group and TARGET_BLOCKS to
1, so that it keeps the group (the steps' tile stays the plan's own rule).
Each group is held bit for bit against the plain versions and timed in a
CUDA graph of ten calls (`tools/profile_kernels.py` `_graph_ms`); the line
of the group that the plan picks is marked.
"""

from __future__ import annotations

from unittest import mock

import torch

from griduniverse_tpu_torch.algos import mc
from griduniverse_tpu_torch.kernels import mc_returns as k13
from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms
from griduniverse_tpu_torch.tools.profile_turns import _smi


def groups(dev, smi) -> None:
    gen = torch.Generator(device=dev).manual_seed(13)
    t = 100
    for b, n_ids in ((256, 81), (1024, 324)):
        valid = torch.arange(t, device=dev)[:, None] < torch.randint(0, t + 1, (b,), generator=gen, device=dev)[None]
        rewards = torch.where(valid, torch.randn((t, b), generator=gen, device=dev), 0.0)
        ids = torch.randint(0, n_ids, (t, b), generator=gen, device=dev, dtype=torch.int32)
        want = mc.discounted_returns(rewards, 0.99), mc.first_visit_mask(ids, valid)
        chosen = k13.plan(t, b)
        for group in (32, 16, 8, 4, 2, 1):
            with mock.patch.multiple(k13, MAX_GROUP=group, TARGET_BLOCKS=1):
                p = k13.plan(t, b)
                if p.group != group:
                    raise SystemExit(f"k13_groups: the plan took {p.group} episodes a block, not {group}")
                got = k13.mc_returns_cuda(rewards, 0.99, ids, valid)
                if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"k13_groups: {group} episodes a block give other bits than the plain versions")
                ms = _graph_ms(lambda: k13.mc_returns_cuda(rewards, 0.99, ids, valid))
            print(f"K13 T={t} B={b} returns and mask, {group} episodes a block ({p.blocks} blocks"
                  f"{', as planned' if p == chosen else ''}): {ms!r} ms in a CUDA graph; bit-exact vs plain ({smi})")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k13_groups: torch.cuda.is_available() is False; this runs only on a GPU")
    smi = _smi()
    print(smi)
    groups(torch.device("cuda", 0), smi)


if __name__ == "__main__":
    main()
