"""The optimizer of the neural trainers: learning-rate schedule, global-norm
clip and Adam, as plain functions on dictionaries of tensors.

PyTorch counterpart of `griduniverse_tpu/models/optim.py` and of what the
reference takes from optax, `chain(clip_by_global_norm(c), adam(lr))`.

One rule, as in the reference: the learning rate is a function of the Adam
step count carried in the optimizer state and of nothing else, so a chunked
or resumed run reads the same rates as an unbroken one. The count is a
tensor, and nothing here reads a tensor on the host, so PPO's `target_kl`
stop can freeze a whole step (parameters, moments and count) with
`torch.where` (`keep_where`).

Two details differ from `torch.optim.Adam` and
`torch.nn.utils.clip_grad_norm_`, and follow optax:
  * the clip leaves gradients alone when `norm < max_norm` and otherwise
    scales them by `max_norm / norm` exactly (no `+ 1e-6`);
  * Adam divides by `sqrt(v̂) + eps`, with the bias corrections applied to
    both moments first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Params = dict[str, torch.Tensor]


def make_lr(
    lr: float,
    schedule: str,
    transition_steps: int | None,
    final_frac: float,
    knob: str,
) -> Callable[[torch.Tensor], float | torch.Tensor]:
    """Resolve (lr, schedule) into `rate(count)`, the learning rate of the
    optimizer step taken at Adam count `count` (a () tensor).

    `"constant"` gives `lr` whatever the count; `"linear"` decays lr →
    lr·final_frac over `transition_steps` optimizer steps and holds the
    final value after. `knob` names the caller's config field for the error
    message."""
    if schedule == "constant":
        return lambda count: lr
    if schedule == "linear":
        if transition_steps is None:
            raise ValueError(f"lr_schedule='linear' needs {knob}")
        end = lr * final_frac
        steps = int(transition_steps)

        def rate(count):
            frac = 1.0 - count.clamp(0, steps).to(torch.float32) / steps
            return (lr - end) * frac + end

        return rate
    raise ValueError(f"unknown lr_schedule {schedule!r}")


@dataclasses.dataclass
class AdamState:
    """Adam's state: the step count (() int32) and both moments, keyed as
    the parameters are."""

    count: torch.Tensor
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    device = next(iter(params.values())).device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """`g` where the global norm is under `max_norm`, else `g / norm ·
    max_norm`."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


def adam_update(
    params: Params, grads: Params, state: AdamState, rate, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[Params, AdamState]:
    """One Adam step at the learning rate `rate(state.count)`. Returns new
    dictionaries; the inputs are not written."""
    lr = rate(state.count)
    count = state.count + 1
    steps = count.to(torch.float32)
    correct1 = 1.0 - b1 ** steps
    correct2 = 1.0 - b2 ** steps
    new_params, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1.0 - b1) * g + b1 * state.mu[k]
        nu[k] = (1.0 - b2) * (g * g) + b2 * state.nu[k]
        step = (mu[k] / correct1) / (torch.sqrt(nu[k] / correct2) + eps)
        new_params[k] = p + (-lr) * step
    return new_params, AdamState(count=count, mu=mu, nu=nu)


def keep_where(keep: torch.Tensor, new, old):
    """`new` where the () bool tensor `keep` is set, else `old`, for a
    parameter dictionary or an `AdamState`; no host read."""
    if isinstance(new, AdamState):
        return AdamState(
            count=torch.where(keep, new.count, old.count),
            mu=keep_where(keep, new.mu, old.mu),
            nu=keep_where(keep, new.nu, old.nu),
        )
    return {k: torch.where(keep, v, old[k]) for k, v in new.items()}
