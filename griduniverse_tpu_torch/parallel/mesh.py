"""The mesh of a sharded run — counterpart of `griduniverse_tpu/parallel/mesh.py`.

The reference shards with `shard_map` over a `jax.sharding.Mesh` of devices.
The port shards over a `torch.distributed` process group, ONE RANK A SHARD,
each rank on its own device: on a host with several cards one rank a card
over NCCL, on the CPU (or ranks sharing one card) over Gloo. An `EnvMesh`
names that group with the reference's axis names:

  * `("env",)` — pure env data-parallelism over every rank;
  * `("host", "env")` — the same ranks laid out hosts × ranks a host, in
    row-major rank order, so `shard_index` is the reference's row-major
    device index (`parallel/bitplane.py` `_global_shard_index`).

Shard k holds rows [k·B/n, (k+1)·B/n) of every env-batched array. A
sharded array is this rank's rows; `all_gather_rows` (and
`distributed.fetch_global`) assemble the whole, in rank order.

Collectives, and why their results do not depend on the backend or the
world size (Q and V must be the same bits on every rank):
  * integers (episode counts, length sums, the shared-Q learner's 64-bit
    fixed-point aggregate) go through `all_reduce` SUM, which is exact;
  * float partials that the reference `psum`s (return sums, the generic
    learner's segment sums) are all-gathered and added in rank order on
    every rank (`all_reduce_sum` on a float tensor);
  * maxima (the solvers' |ΔV|, PI's "changed" flag) go through `all_reduce`
    MAX, which is exact.
A world of one that never initialised a process group has `group=None`,
and every collective returns its input.

Gloo takes CPU tensors, and both collectives used here, `all_reduce` and
`all_gather`, also take CUDA tensors as they are (ranks sharing one card:
NCCL refuses two ranks on one device): `chip_smoke.py` phase 26 (b) tries
each on the card and prints what it finds. So no collective is staged
through the host.

The reference's `env_spec`, `env_sharding` and `replicated_sharding` name
JAX `PartitionSpec`s and `NamedSharding`s, which have no torch counterpart,
and are not carried over.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.platform import rank_device

ENV_AXIS = "env"
HOST_AXIS = "host"

@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """A process group seen as the reference's mesh: axis names, the layout
    `shape` (its product is `size`), this process's `rank` and `device`, and
    the `group` (None for a world of one with no process group)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    size: int
    device: torch.device
    group: object | None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else str(dist.get_backend(self.group))


def _world() -> tuple[int, int, object | None]:
    """(rank, size, group) of the default process group, or of a world of
    one where none was initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    return 0, 1, None


def make_env_mesh(num_shards: int | None = None, *, device=None) -> EnvMesh:
    """1-D `("env",)` mesh over every rank of the default process group
    (a world of one where none was initialised). `num_shards`, if given,
    must be that world size. `device`: this rank's (default: card
    rank mod the cards it sees, `utils.platform.rank_device`)."""
    rank, size, group = _world()
    if num_shards is not None and int(num_shards) != size:
        raise ValueError(
            f"num_shards={num_shards}, but the process group has {size} rank(s): "
            "one rank a shard (call distributed.initialize with that world size)"
        )
    return EnvMesh((ENV_AXIS,), (size,), rank, size, rank_device(rank, device), group)


def make_host_env_mesh(
    num_hosts: int | None = None, per_host: int | None = None, *, device=None
) -> EnvMesh:
    """2-D `("host", "env")` mesh: the ranks in row-major order as
    `num_hosts` × `per_host`. By default two hosts where the world is even
    and above one (the reference emulates two hosts on one process the
    same way), else one."""
    rank, size, group = _world()
    if num_hosts is None:
        num_hosts = 2 if size > 1 and size % 2 == 0 else 1
    if per_host is None:
        per_host = size // num_hosts
    if num_hosts * per_host != size:
        raise ValueError(f"{num_hosts} hosts x {per_host} ranks != world size {size}")
    return EnvMesh((HOST_AXIS, ENV_AXIS), (num_hosts, per_host), rank, size,
                   rank_device(rank, device), group)


def env_axes(mesh: EnvMesh) -> tuple[str, ...]:
    """All mesh axes that shard the env batch (every axis, by convention)."""
    return tuple(mesh.axis_names)


def shard_index(mesh: EnvMesh) -> int:
    """Row-major index of this rank over every mesh axis: its rank."""
    return mesh.rank


def local_batch(mesh: EnvMesh, batch_size: int) -> int:
    """Envs a shard holds; raises where the mesh does not divide the batch."""
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    return batch_size // mesh.size


def shard_rows(mesh: EnvMesh, batch_size: int) -> slice:
    """This rank's rows of a batch of `batch_size`."""
    local = local_batch(mesh, batch_size)
    return slice(mesh.rank * local, (mesh.rank + 1) * local)


def tree_map(fn, tree, leaves=(torch.Tensor,)):
    """`fn` on every leaf of type `leaves` (tensors) of a tree of
    dataclasses, (named) tuples, lists and dicts; other leaves (ints, None)
    are kept."""
    if isinstance(tree, leaves):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), leaves) for f in dataclasses.fields(tree)
        })
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x, leaves) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaves) for k, v in tree.items()}
    return tree


def shard_env_state(mesh: EnvMesh, state):
    """This rank's rows of a global batched state (any tree of tensors with
    a leading env axis; 0-d tensors are kept whole), on the mesh's device."""
    def rows(x):
        if x.dim() == 0:
            return x.to(mesh.device)
        return x[shard_rows(mesh, int(x.shape[0]))].to(mesh.device)

    return tree_map(rows, state)


def _all_reduce(mesh: EnvMesh, x: torch.Tensor, op) -> torch.Tensor:
    if mesh.group is not None:
        dist.all_reduce(x, op, group=mesh.group)
    return x


def _gather(mesh: EnvMesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `x`, in rank order (gathered flat, of any shape)."""
    src = x.contiguous().reshape(-1)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return [p.reshape(x.shape) for p in parts]


def all_reduce_sum(mesh: EnvMesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the ranks, the same bits on every rank. An integer
    tensor is summed in place by `all_reduce` (exact) and returned; a float
    tensor's sum is a new tensor, the ranks' values added in rank order."""
    if mesh.group is None:
        return x
    if x.is_floating_point():
        parts = _gather(mesh, x)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total
    return _all_reduce(mesh, x, dist.ReduceOp.SUM)


def all_reduce_max(mesh: EnvMesh, x: torch.Tensor) -> torch.Tensor:
    """Maximum of `x` over the ranks, in place (exact), returned."""
    return _all_reduce(mesh, x, dist.ReduceOp.MAX)


def all_gather_rows(mesh: EnvMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` concatenated in rank order: the global
    array of which `x` is this rank's shard."""
    if mesh.group is None:
        return x
    return torch.cat(_gather(mesh, x))


def all_gather_rows_into(mesh: EnvMesh, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """`all_gather_rows` written into `out` (the ranks' rows of `x` in rank
    order; `out` contiguous, of `size` × x's rows). Returns `out`."""
    if mesh.group is None:
        return out.copy_(x)
    dist.all_gather(list(out.chunk(mesh.size)), x.contiguous(), group=mesh.group)
    return out


def all_gather_columns(mesh: EnvMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's columns of a (T, B_local, ...) tensor concatenated in
    rank order along axis 1: the (T, B, ...) array of which `x` is this
    rank's shard."""
    if mesh.group is None:
        return x
    return all_gather_rows(mesh, x.transpose(0, 1).contiguous()).transpose(0, 1)
