"""Neural networks for the gridworld learners.

PyTorch counterpart of `griduniverse_tpu/models/networks.py`: the same three
actor-critic families with the same constructor fields and call signatures
(`net(obs)`, `net(obs, tiles)`; any leading batch shape), as `nn.Module`s.

  * Observations are state indices. `ActorCritic` embeds them with a row
    lookup, `table.to(cdt)[obs]` (kernel K9a, `embed_rows`). The reference
    writes the lookup as a one-hot product for the TPU's matrix unit; a
    one-hot product selects exact rows, so the values are the same.
  * The conv trunks split their first layer as the reference does: the tile
    planes go through a conv once per level, and the agent plane, a one-hot
    image, adds the layer's 3×3 agent kernel stamped around the agent's
    cell. The stamp, the add of the tile response, the bias and the ReLU are
    one pass (kernel K9b, `agent_stamp`).
  * Mixed precision by explicit casts: parameters are float32; every
    `F.linear` and `F.conv2d` gets its input, weight and bias cast to
    `compute_dtype` (bfloat16 by default); the heads' outputs are cast back
    to float32, so losses, softmaxes and advantages stay float32. With
    `compute_dtype="float32"` the casts are no-ops and nothing is rounded;
    `exact_kernels()` keeps the library's convs out of TF32 and on
    deterministic algorithms.
  * Parameter names map one to one to the flax tree (`embed`,
    `dense_i.weight/bias`, `conv_0_kernel`, `conv_0_bias`,
    `conv_i.weight/bias`, `policy_head`, `value_head`); Dense kernels are
    stored (out, in) and conv kernels OIHW, torch's layouts
    (`utils.convert.to_network_state` transposes). Images are NHWC in
    memory, as in the reference, so the flatten before `dense_0` runs over
    (H, W, C) and loaded weights meet the right columns.
  * Initialisers are flax's: normal(1/sqrt(embed_dim)) for the table,
    `lecun_normal` (truncated at two standard deviations) for Dense and conv
    kernels, zero biases, drawn from an explicit `torch.Generator`. The
    draws are torch's, not threefry's.

Each kernel has its plain PyTorch version here (`embed_rows_reference`,
`agent_stamp_reference`), which CPU tensors take; CUDA tensors launch the
kernel, or raise. The backward kernels' sums run in a fixed order, which
`embed_rows_backward_reference` and `agent_stamp_backward_reference` repeat
add by add, so a kernel's gradients can be held bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..kernels import agent_stamp as stamp_kernels
from ..kernels.agent_stamp import agent_stamp_backward_cuda, agent_stamp_cuda
from ..kernels.embed_rows import CHUNK as EMBED_CHUNK
from ..kernels.embed_rows import embed_rows_backward_cuda, embed_rows_cuda
from ..utils.platform import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


@contextlib.contextmanager
def exact_kernels():
    """While active, cuDNN picks deterministic algorithms, does not
    auto-tune, and computes float32 convs in float32 (not TF32): a chunked or
    resumed run repeats an unbroken one bit for bit, and
    `compute_dtype="float32"` is exact. The trainers and the evaluation hold
    it around their forward and backward passes. The earlier settings come
    back on exit."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = True, False, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# K9a: the index embedding
# ---------------------------------------------------------------------------


def embed_rows_reference(table, obs, dtype: torch.dtype):
    """Plain PyTorch version of K9a: `table.to(dtype)[obs]`, written as
    `table[obs].to(dtype)` so that autograd's gradient sums in float32."""
    return table[obs.long()].to(dtype)


def embed_rows_backward_reference(grad, obs, num_states: int):
    """Plain PyTorch version of K9a's backward, in the kernel's own order of
    float adds: per chunk of `EMBED_CHUNK` consecutive samples a partial
    (S, E) table filled in sample order, then the partial tables added in
    chunk order. Each pass adds one sample position of every chunk, at
    indices that are unique within the pass, so no pass depends on the
    order in which its adds land."""
    n, e = grad.shape
    num_chunks = -(-n // EMBED_CHUNK)
    pad = num_chunks * EMBED_CHUNK - n
    # padding samples go to a spare row that is dropped at the end
    rows = F.pad(obs.long(), (0, pad), value=num_states).reshape(num_chunks, EMBED_CHUNK)
    g = F.pad(grad.float(), (0, 0, 0, pad)).reshape(num_chunks, EMBED_CHUNK, e)
    partial = torch.zeros((num_chunks, num_states + 1, e), dtype=torch.float32, device=grad.device)
    chunk_ids = torch.arange(num_chunks, device=grad.device)
    for c in range(EMBED_CHUNK):
        partial[chunk_ids, rows[:, c]] = partial[chunk_ids, rows[:, c]] + g[:, c]
    dtable = torch.zeros((num_states + 1, e), dtype=torch.float32, device=grad.device)
    for j in range(num_chunks):
        dtable = dtable + partial[j]
    return dtable[:num_states]


class _EmbedRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, obs, dtype):
        ctx.save_for_backward(obs)
        ctx.num_states = int(table.shape[0])
        return embed_rows_cuda(table, obs, dtype)

    @staticmethod
    def backward(ctx, grad):
        (obs,) = ctx.saved_tensors
        return embed_rows_backward_cuda(grad.contiguous(), obs, ctx.num_states), None, None


def embed_rows(table, obs, dtype: torch.dtype):
    """`table.to(dtype)[obs]` for a (S, E) float32 table and (N,) int32
    indices in [0, S) → (N, E) (K9a on CUDA, forward and backward). The
    backward's sums do not depend on thread order: two runs give the same
    bits."""
    if not kernels.on_cuda(table, obs):
        return embed_rows_reference(table, obs, dtype)
    if not (table.requires_grad and torch.is_grad_enabled()):  # no graph to record: the kernel alone
        return embed_rows_cuda(table, obs, dtype)
    return _EmbedRows.apply(table, obs, dtype)


# ---------------------------------------------------------------------------
# K9b: the agent plane of the first conv layer
# ---------------------------------------------------------------------------


def agent_stamp_reference(y_tiles, k_agent, bias, obs):
    """Plain PyTorch version of K9b; the gradients are autograd's.

    y_tiles (Nl, H, W, C) in the compute dtype, k_agent (3, 3, C) and bias
    (C,) float32, obs (N,) int32 with N a multiple of Nl, sample n on level
    n mod Nl → `relu((stamp + y_tiles[level]) + bias)` as (N, H, W, C) in the
    compute dtype, where stamp[n, y, x] = k_agent[ay−y+1, ax−x+1] within one
    cell of the agent's (ay, ax) and 0 elsewhere. k_agent and bias are
    rounded to the compute dtype first; the sums are float32."""
    nl, h, w, ch = y_tiles.shape
    cdt = y_tiles.dtype
    n = obs.shape[0]
    dev = y_tiles.device
    cell = obs.long()
    di = torch.div(cell, w, rounding_mode="floor")[:, None] - torch.arange(h, device=dev) + 1  # (N, H)
    dj = (cell % w)[:, None] - torch.arange(w, device=dev) + 1  # (N, W)
    near = ((di >= 0) & (di < 3))[:, :, None] & ((dj >= 0) & (dj < 3))[:, None, :]
    k = k_agent.to(cdt).float()
    stamp = k[di.clamp(0, 2)[:, :, None], dj.clamp(0, 2)[:, None, :]]  # (N, H, W, C)
    stamp = torch.where(near[..., None], stamp, 0.0)
    v = (stamp.reshape(n // nl, nl, h, w, ch) + y_tiles.float()) + bias.to(cdt).float()
    return torch.relu(v).to(cdt).reshape(n, h, w, ch)


def agent_stamp_backward_reference(grad, out, obs, num_levels: int):
    """Plain PyTorch version of K9b's backward, in the kernel's own order of
    float adds (`csrc/agent_stamp.cu`'s header; the cut is
    `kernels.agent_stamp.plan`'s). With gm = `grad` where the saved output
    `out` is positive and 0 elsewhere, all sums float32:

      * a unit is a range of `T_RANGE` samples a level and a tile of
        `cells` consecutive cells of the (Nl·H·W) levels' cells; block β
        takes a run of `upb` units in order, its thread (row ρ, channel c)
        the tile's cell ρ. For each unit the thread adds gm over the range,
        t ascending, into D (dy_tiles' term, written out per range) and
        into A[i·3 + j] where its cell is (ay−i+1, ax−j+1) of the sample's
        agent; then B += D. A and B start at 0.0 for the block;
      * a block's rows are added by a tree (row ρ < s takes row ρ + s, for
        s = cells/2, ..., 1), and the blocks' partials P as
        Σ_ρ (Σ_m P[m·SUM_LANES + ρ]), ρ < SUM_LANES, each sum from 0.0;
      * dy_tiles is D where a level has one range, else the ranges' D added
        in order from 0.0; it is rounded to the compute dtype once.

    Returns (dy_tiles (Nl, H, W, C) in the compute dtype, dk (3, 3, C) and
    dbias (C,) float32). It is slow: a few small operations per sample of a
    unit."""
    n, h, w, ch = grad.shape
    nl, hw = num_levels, h * w
    t_len, n_cells = n // num_levels, num_levels * h * w
    dev = grad.device
    p = stamp_kernels.plan(n, nl, h, w, ch, grad.dtype)
    t_range = stamp_kernels.T_RANGE
    gm = torch.where(out > 0, grad.float(), 0.0).reshape(t_len, n_cells, ch)
    cell = obs.long().reshape(t_len, nl)
    ay_all = torch.div(cell, w, rounding_mode="floor")
    ax_all = cell - ay_all * w
    blocks, rows = torch.arange(p.blocks, device=dev), torch.arange(p.cells, device=dev)
    # each thread's ten sums, A[0..8] and B: (blocks, cells, 10, C). An add of
    # 0.0 where the kernel adds nothing changes no bit: no sum is ever -0.0.
    acc = torch.zeros((p.blocks, p.cells, 10, ch), dtype=torch.float32, device=dev)
    dy = torch.zeros((p.ranges, n_cells, ch), dtype=torch.float32, device=dev)
    for m in range(p.upb):
        u = blocks * p.upb + m
        r, k = torch.div(u, p.tiles, rounding_mode="floor"), u % p.tiles
        gc = k[:, None] * p.cells + rows  # (blocks, cells)
        active = (u < p.units)[:, None] & (gc < n_cells)
        gc = gc.clamp(max=n_cells - 1)
        lvl, cy, cx = torch.div(gc, hw, rounding_mode="floor"), torch.div(gc % hw, w, rounding_mode="floor"), gc % w
        d = torch.zeros((p.blocks, p.cells, ch), dtype=torch.float32, device=dev)
        for s in range(min(t_range, t_len)):
            t = r * t_range + s
            live = active & (t < t_len)[:, None]
            tc = t.clamp(max=t_len - 1)[:, None]
            g = torch.where(live[..., None], gm[tc, gc], 0.0)
            d = d + g
            di, dj = ay_all[tc, lvl] - cy + 1, ax_all[tc, lvl] - cx + 1
            hit = live & (di >= 0) & (di < 3) & (dj >= 0) & (dj < 3)
            q = (di.clamp(0, 2) * 3 + dj.clamp(0, 2))[..., None, None].expand(-1, -1, 1, ch)
            acc.scatter_(2, q, acc.gather(2, q) + torch.where(hit[..., None, None], g[:, :, None], 0.0))
        dy[r[:, None].expand_as(gc)[active], gc[active]] = d[active]
        acc[:, :, 9] = acc[:, :, 9] + d
    s = p.cells // 2
    while s:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    lanes = stamp_kernels.SUM_LANES
    part = F.pad(acc[:, 0].reshape(p.blocks, -1), (0, 0, 0, -p.blocks % lanes)).reshape(-1, lanes, 10 * ch)
    inner = torch.zeros((lanes, 10 * ch), dtype=torch.float32, device=dev)
    for m in range(part.shape[0]):
        inner = inner + part[m]
    total = torch.zeros((10 * ch,), dtype=torch.float32, device=dev)
    for rho in range(lanes):
        total = total + inner[rho]
    if p.ranges > 1:
        dy_sum = torch.zeros((n_cells, ch), dtype=torch.float32, device=dev)
        for r in range(p.ranges):
            dy_sum = dy_sum + dy[r]
    else:
        dy_sum = dy[0]
    total = total.reshape(10, ch)
    return dy_sum.to(grad.dtype).reshape(nl, h, w, ch), total[:9].reshape(3, 3, ch), total[9]


class _AgentStamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_tiles, k_agent, bias, obs):
        out = agent_stamp_cuda(y_tiles, k_agent, bias, obs)
        ctx.save_for_backward(out, obs)
        ctx.num_levels = int(y_tiles.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        out, obs = ctx.saved_tensors
        dy_tiles, dk, dbias = agent_stamp_backward_cuda(grad.contiguous(), out, obs, ctx.num_levels)
        return dy_tiles, dk, dbias, None


def agent_stamp(y_tiles, k_agent, bias, obs):
    """The first conv layer's output from its tile response: see
    `agent_stamp_reference` (K9b on CUDA, forward and backward; the
    backward's sums are in a fixed order)."""
    if not kernels.on_cuda(y_tiles, k_agent, bias, obs):
        return agent_stamp_reference(y_tiles, k_agent, bias, obs)
    return _AgentStamp.apply(y_tiles.contiguous(), k_agent.contiguous(), bias, obs)


# ---------------------------------------------------------------------------
# The modules
# ---------------------------------------------------------------------------


def _truncated_normal(shape, std: float, generator, device) -> torch.Tensor:
    """flax's `lecun_normal` draw: a normal truncated at ±2 standard
    deviations, rescaled to have standard deviation `std`."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    x = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    return x.clamp(-2, 2) * (std / 0.87962566103423978)


class _ActorCriticBase(nn.Module):
    """What the three families share: initialisation, the cast-and-apply
    helper, the MLP trunk and the two heads."""

    needs_tiles = False

    def _make_heads(self, in_features: int, device) -> None:
        for i, width in enumerate(self.hidden):
            self.add_module(f"dense_{i}", nn.Linear(in_features, width, device=device))
            in_features = width
        self.policy_head = nn.Linear(in_features, self.num_actions, device=device)
        self.value_head = nn.Linear(in_features, 1, device=device)

    def _finish(self, seed: int) -> None:
        device = next(self.parameters()).device
        generator = torch.Generator(device=device).manual_seed(int(seed))
        self.load_state_dict(self.init_params(generator))

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Fresh parameters by flax's initialisers, keyed as `state_dict`."""
        out = {}
        for name, p in self.named_parameters():
            if name == "embed":
                value = torch.randn(p.shape, generator=generator, device=p.device) / math.sqrt(p.shape[1])
            elif p.dim() == 1:
                value = torch.zeros_like(p)
            else:  # Dense (out, in) or conv OIHW: fan_in is everything but O
                value = _truncated_normal(p.shape, 1 / math.sqrt(p[0].numel()), generator, p.device)
            out[name] = value
        return out

    @property
    def cdt(self) -> torch.dtype:
        return compute_dtype_of(self.compute_dtype)

    def _linear(self, layer: nn.Linear, x):
        return F.linear(x, layer.weight.to(self.cdt), layer.bias.to(self.cdt))

    def _heads(self, x, batch_shape):
        for i in range(len(self.hidden)):
            x = torch.relu(self._linear(getattr(self, f"dense_{i}"), x))
        logits = self._linear(self.policy_head, x).float()
        value = self._linear(self.value_head, x)[..., 0].float()
        return logits.reshape(*batch_shape, self.num_actions), value.reshape(batch_shape)


class ActorCritic(_ActorCriticBase):
    """Index embedding → MLP trunk → (policy logits, value), both float32.

    num_states — size of the discrete observation space (H·W).
    num_actions — policy head width.
    hidden — trunk layer widths.
    seed — of the generator the initial parameters are drawn from.
    """

    def __init__(self, num_states: int, num_actions: int, hidden: Sequence[int] = (128, 128),
                 embed_dim: int = 64, compute_dtype: str = "bfloat16", *, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        compute_dtype_of(compute_dtype)
        self.num_states, self.num_actions = int(num_states), int(num_actions)
        self.hidden, self.embed_dim, self.compute_dtype = tuple(hidden), int(embed_dim), compute_dtype
        self.embed = nn.Parameter(torch.empty((self.num_states, self.embed_dim), device=device))
        self._make_heads(self.embed_dim, device)
        self._finish(seed)

    def forward(self, obs):
        x = embed_rows(self.embed, obs.reshape(-1).to(torch.int32), self.cdt)
        return self._heads(x, obs.shape)


class _ConvBase(_ActorCriticBase):
    """The conv trunk both grid-observation families share."""

    def _make_trunk(self, height, width, num_actions, num_tile_types, channels, hidden,
                    compute_dtype, seed, device) -> None:
        if not channels:
            raise ValueError(f"{type(self).__name__} needs at least one conv layer")
        compute_dtype_of(compute_dtype)
        self.height, self.width, self.num_actions = int(height), int(width), int(num_actions)
        self.num_tile_types, self.channels = int(num_tile_types), tuple(channels)
        self.hidden, self.compute_dtype = tuple(hidden), compute_dtype
        ch0 = self.channels[0]
        self.conv_0_kernel = nn.Parameter(torch.empty((ch0, self.num_tile_types + 1, 3, 3), device=device))
        self.conv_0_bias = nn.Parameter(torch.empty((ch0,), device=device))
        for i in range(1, len(self.channels)):
            self.add_module(f"conv_{i}", nn.Conv2d(self.channels[i - 1], self.channels[i], 3, padding=1, device=device))
        self._make_heads(self.height * self.width * self.channels[-1], device)
        self._finish(seed)

    def _trunk(self, obs, tiles):
        """obs any batch shape; tiles (Nl, H, W, C) one-hot planes in the
        compute dtype, sample n on level n mod Nl."""
        cdt, c = self.cdt, self.num_tile_types
        flat = obs.reshape(-1).to(torch.int32)
        with exact_kernels():
            y = F.conv2d(tiles.permute(0, 3, 1, 2), self.conv_0_kernel[:, :c].to(cdt), padding=1)
            y_tiles = y.permute(0, 2, 3, 1).contiguous()  # (Nl, H, W, ch0): once per level
            k_agent = self.conv_0_kernel[:, c].permute(1, 2, 0).contiguous()  # (3, 3, ch0)
            x = agent_stamp(y_tiles, k_agent, self.conv_0_bias, flat)  # (N, H, W, ch0)
            x = x.permute(0, 3, 1, 2)  # NCHW for the library, NHWC in memory
            for i in range(1, len(self.channels)):
                layer = getattr(self, f"conv_{i}")
                x = torch.relu(F.conv2d(x, layer.weight.to(cdt), layer.bias.to(cdt), padding=1))
        x = x.permute(0, 2, 3, 1).reshape(flat.shape[0], -1)  # flatten over (H, W, C)
        return self._heads(x, obs.shape)


class BatchedConvActorCritic(_ConvBase):
    """Grid-observation actor-critic for PER-ENV levels: the level enters at
    call time, `net(obs, tiles)` with obs (...,) int32 state indices and
    tiles (Bl..., H, W, C) one-hot tile planes, where `Bl...` is a trailing
    suffix of obs's batch shape. The canonical case is obs (T, B) over a
    rollout with tiles (B, H, W, C): each env keeps one level, so the planes
    carry no time axis and their conv runs once per level, not per sample.

    The parameters have the names and shapes of `ConvActorCritic`'s, so they
    transfer between the two. `agent_plane` is accepted as in the reference
    ("stamp" or "conv", two lowerings of one function there), checked and
    not kept: in the port both run the same fused pass (K9b) and give the
    same values.
    """

    needs_tiles = True

    def __init__(self, height: int, width: int, num_actions: int, num_tile_types: int = 4,
                 channels: Sequence[int] = (32, 32), hidden: Sequence[int] = (128,),
                 compute_dtype: str = "bfloat16", agent_plane: str = "stamp", *, seed: int = 0,
                 device=None):
        super().__init__()
        if agent_plane not in ("stamp", "conv"):
            raise ValueError(f"unknown agent_plane mode: {agent_plane!r}")
        self._make_trunk(height, width, num_actions, num_tile_types, channels, hidden,
                         compute_dtype, seed, resolve_device(device))

    def forward(self, obs, tiles):
        plane = (self.height, self.width, self.num_tile_types)
        if tuple(tiles.shape[-3:]) != plane:
            raise ValueError(f"tiles trailing dims {tuple(tiles.shape[-3:])} != {plane}")
        lvl_shape = tuple(tiles.shape[:-3])
        if lvl_shape != tuple(obs.shape[obs.dim() - len(lvl_shape):]):
            raise ValueError(
                f"tiles batch shape {lvl_shape} is not a trailing suffix of obs batch shape {tuple(obs.shape)}")
        return self._trunk(obs, tiles.reshape(-1, *plane).to(self.cdt))


class ConvActorCritic(_ConvBase):
    """Grid-observation actor-critic over ONE shared level: `net(obs)` with
    any leading batch shape, a drop-in for `ActorCritic`. `grid` holds the
    level's H·W tile codes, row-major; its one-hot tile planes are a buffer
    of the module, and their conv runs once per call."""

    def __init__(self, height: int, width: int, grid, num_actions: int, num_tile_types: int = 4,
                 channels: Sequence[int] = (32, 32), hidden: Sequence[int] = (128,),
                 compute_dtype: str = "bfloat16", *, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self._make_trunk(height, width, num_actions, num_tile_types, channels, hidden,
                         compute_dtype, seed, device)
        codes = torch.as_tensor(grid, dtype=torch.int64, device=device).reshape(1, self.height, self.width)
        self.grid = tuple(int(v) for v in codes.reshape(-1).tolist())
        self.register_buffer("tiles", F.one_hot(codes, self.num_tile_types).to(self.cdt), persistent=False)

    def forward(self, obs):
        return self._trunk(obs, self.tiles)
