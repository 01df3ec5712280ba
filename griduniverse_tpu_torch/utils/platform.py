"""Device choice — counterpart of `griduniverse_tpu/utils/platform.py`.

The port runs on the card unless the caller asks for the CPU: every
constructor and factory that takes `device=None` resolves it here. There
is no test of `torch.cuda.is_available()`: on a machine without a card a
call with no `device` raises torch's own error instead of quietly
computing on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → `torch.device("cuda")`; anything else is taken as given."""
    return torch.device("cuda" if device is None else device)


def rank_device(local_rank: int, device=None) -> torch.device:
    """A rank's device: `device` if given, else card `local_rank` modulo the
    cards this process sees (one rank a card), `cuda` where it sees none,
    so that the first use raises torch's own error."""
    if device is not None:
        return torch.device(device)
    count = torch.cuda.device_count()
    return resolve_device(None) if count == 0 else torch.device("cuda", int(local_rank) % count)
