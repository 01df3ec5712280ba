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
