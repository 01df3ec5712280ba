"""Checkpoint / resume of a whole learner state through disk.

PyTorch counterpart of `griduniverse_tpu/utils/checkpoint.py`, without
orbax: a state (dataclasses, dicts, tuples and NamedTuples of tensors and
plain scalars) is flattened to `{path: tensor}`, written with `torch.save`
and read back with `torch.load(..., weights_only=True)`; the non-tensor
leaves (the integer seed, step counters) go to a small JSON manifest beside
it. A checkpoint is a directory holding `tensors.pt` and `manifest.json`,
written to a temporary directory first and moved into place with
`os.replace`, so a reader never sees half of one.

Restoring needs a template of the same structure (a freshly initialised
train state): every leaf comes back on the template's device, and a path,
shape, dtype or scalar type that differs from the template's raises.

Bit-exact resume rests on the same two properties as the reference's: all
learner state is explicit (parameters, optimizer, env state, the replay ring,
counters), and every draw is counter-based, a function of (seed, step), so a
resumed run makes the draws the unbroken run would have.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import torch

TENSORS = "tensors.pt"
MANIFEST = "manifest.json"
_SCALARS = (bool, int, float, str, type(None))


def _children(node) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of a container, in a fixed order; None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    return None


def _rebuild(node, children: list):
    """A container like `node` holding `children` (in `_children`' order)."""
    if dataclasses.is_dataclass(node):
        names = [f.name for f in dataclasses.fields(node)]
        return dataclasses.replace(node, **dict(zip(names, children)))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return dict(zip(node.keys(), children))


def flatten(state, prefix: str = "") -> dict[str, Any]:
    """Every leaf of `state` by its path (`a/b/0`): tensors and scalars."""
    kids = _children(state)
    if kids is None:
        if not isinstance(state, (torch.Tensor, *_SCALARS)):
            raise TypeError(f"{prefix or 'state'}: cannot checkpoint a {type(state).__name__}")
        return {prefix: state}
    out: dict[str, Any] = {}
    for name, child in kids:
        out.update(flatten(child, f"{prefix}/{name}" if prefix else name))
    return out


def _unflatten(template, leaves: dict[str, Any], prefix: str = ""):
    kids = _children(template)
    if kids is None:
        return leaves[prefix]
    return _rebuild(template, [
        _unflatten(child, leaves, f"{prefix}/{name}" if prefix else name) for name, child in kids
    ])


def _snapshot(state) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Host copies of the tensors (one copy each, then one synchronize) and
    the scalars of `state`, by path."""
    tensors, scalars = {}, {}
    for path, leaf in flatten(state).items():
        if isinstance(leaf, torch.Tensor):
            tensors[path] = leaf.detach().to("cpu", copy=True, non_blocking=leaf.is_cuda)
        else:
            scalars[path] = leaf
    if any(t.is_pinned() for t in tensors.values()):
        torch.cuda.synchronize()
    return tensors, scalars


def _write(path: str, tensors: dict[str, torch.Tensor], scalars: dict[str, Any]) -> None:
    """Write a snapshot to the directory `path` atomically, replacing what
    is there."""
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}-{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tensors, os.path.join(tmp, TENSORS))
    with open(os.path.join(tmp, MANIFEST), "w", encoding="utf-8") as f:
        json.dump({"scalars": scalars, "tensors": sorted(tensors)}, f)
    if os.path.exists(path):
        old = f"{tmp}.old"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)


def save_checkpoint(path: str | os.PathLike, state: Any) -> None:
    """Write `state` as a checkpoint to the directory `path`, atomically."""
    _write(os.path.abspath(os.fspath(path)), *_snapshot(state))


def restore_checkpoint(path: str | os.PathLike, template: Any) -> Any:
    """Read the checkpoint at `path` into the structure of `template`: each
    tensor on the template leaf's device; raises if a path, a shape, a dtype
    or a scalar's type differs from the template's."""
    path = os.path.abspath(os.fspath(path))
    with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
        scalars = json.load(f)["scalars"]
    tensors = torch.load(os.path.join(path, TENSORS), map_location="cpu", weights_only=True)
    want = flatten(template)
    saved = set(tensors) | set(scalars)
    if saved != set(want):
        raise ValueError(f"{path}: the checkpoint's paths differ from the template's: missing "
                         f"{sorted(set(want) - saved)}, unexpected {sorted(saved - set(want))}")
    leaves = {}
    for key, like in want.items():
        if isinstance(like, torch.Tensor):
            got = tensors.get(key)
            if got is None or got.shape != like.shape or got.dtype != like.dtype:
                found = "a scalar" if got is None else f"{got.dtype} {tuple(got.shape)}"
                raise ValueError(f"{path}: {key} is {found}, the template's "
                                 f"{like.dtype} {tuple(like.shape)}")
            leaves[key] = got.to(like.device)
        else:
            if key not in scalars or type(scalars[key]) is not type(like):
                raise ValueError(f"{path}: {key} is not a {type(like).__name__} as in the template")
            leaves[key] = scalars[key]
    return _unflatten(template, leaves)


class CheckpointManager:
    """Keep the latest K checkpoints of a training loop, one directory a
    step (`step_000000000120`).

    Usage:
        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(step, train_state)
        step, state = mgr.restore_latest(template)   # (0, template) if none

    `async_=True` overlaps the disk write with training: `save` copies the
    tensors to host memory (one copy each, then one synchronize: the only
    part that waits for the device) and writes them in one background
    thread. That write is JOINED before the next save, restore or listing,
    and any error it raised is raised there (or at an explicit `wait()` or
    `close()`), never dropped. Saving only reads the state, so async saves
    cannot perturb a bit-exact resume.
    """

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3, async_: bool = False):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._async = bool(async_)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self) -> None:
        """Join the write in flight, raising its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Join the write in flight; later saves write synchronously
        (idempotent)."""
        self.wait()
        self._async = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def steps(self) -> list[int]:
        """The saved steps, in order."""
        self.wait()
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def _background_write(self, path, tensors, scalars) -> None:
        try:
            _write(path, tensors, scalars)
        except Exception as err:  # raised again by the next wait()
            self._error = err

    def save(self, step: int, state: Any) -> None:
        existing = self.steps()  # joins the write in flight, raising its error
        if self._async:
            # prune before the new write starts: keep max_to_keep - 1 and the new one
            keep = self.max_to_keep - 1
            excess = [s for s in (existing[:-keep] if keep > 0 else existing) if s != step]
            tensors, scalars = _snapshot(state)
            self._thread = threading.Thread(
                target=self._background_write, args=(self._step_dir(step), tensors, scalars),
                daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self._step_dir(step), state)
            excess = sorted(set(existing) | {step})[: -self.max_to_keep]
        for old in excess:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore_latest(self, template: Any) -> tuple[int, Any]:
        steps = self.steps()  # a save in flight must be visible to resume
        if not steps:
            return 0, template
        return steps[-1], restore_checkpoint(self._step_dir(steps[-1]), template)
