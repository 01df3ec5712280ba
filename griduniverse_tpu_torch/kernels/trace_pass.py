"""Wrapper of K12 (`csrc/trace_pass.cu`): a plan built once a run, then one
launch a step; and of its partial-sums form for the sharded learners, two
launches a step around the ranks' collectives (`TracePartialsPlan`).

The plain PyTorch versions are `algos.td_lambda.trace_pass_reference`, and
`trace_partials_reference` and `apply_partials_reference` for the form.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

# Envs whose products a thread sums before the chunks are added in order: a
# constant of the algorithm (`kChunk` in the source), so changing it changes
# the bits of every table the pass updates.
CHUNK = 256
TILE = 128  # cells a block, a thread a cell (`kTile`)
# an applier's four warps each add a quarter of the chunks in two groups of
# 32 at a time: the partial sums are padded with zero rows to a multiple of
# 256 chunks (`kApplyChunks`)
APPLY_CHUNKS = 256
MAX_BLOCKS = (1 << 31) - 1  # the grid's x dimension: tiles × chunks blocks


def launches(batch: int) -> int:
    """Kernels one trace step launches at `batch` envs: one, at any batch."""
    check_int("batch", batch, low=1)
    return 1


def scratch_words(batch: int, n_cells: int) -> dict[str, int]:
    """The 4-byte words of a plan's scratch: a partial sum for each (chunk
    of CHUNK envs, cell), the chunks padded with zero rows to a multiple of
    APPLY_CHUNKS, a live count a cell, and a ticket and a count of finished
    appliers a tile of TILE cells. The padding, counts and tickets start at
    0, and every step leaves them 0."""
    chunks, tiles = -(-batch // CHUNK), -(-n_cells // TILE)
    if chunks * tiles > MAX_BLOCKS:
        raise ValueError(f"a trace of {batch} envs x {n_cells} cells takes more than {MAX_BLOCKS} blocks")
    return {"partial": -(-chunks // APPLY_CHUNKS) * APPLY_CHUNKS * n_cells, "count": n_cells, "tickets": 2 * tiles}


def appliers(n_cells: int, sms: int) -> int:
    """Blocks a tile that add its partial sums: the tile's last 4, 2 or 1
    tickets, each a quarter, half or all of its cells. Every applier but the
    very last waits for the tile's other blocks, so the appliers of all
    tiles together are kept to two blocks an SM: the kernel holds at least
    four an SM (`__launch_bounds__`), so the blocks they wait for always
    find room."""
    tiles = -(-n_cells // TILE)
    return next((r for r in (4, 2) if r * tiles <= 2 * sms), 1)


class TracePassPlan:
    """K12 for one run: the shapes checked once and the scratch of the
    cross-chunk sum (`scratch_words`), zeroed once, built once a run by
    `algos.td_lambda`'s loops (`trace_pass(..., plan=)`).

    The scratch is stream-ordered: every step reuses it, so the calls of a
    plan must follow one another on one stream, the stream current on the
    plan's device when it was built (a CUDA graph's capture stream, for a
    captured step). A call from another stream raises.

    A call (`plan(table, e, s, a, delta, cut, gamma_lam, cutoff, alpha,
    replacing)`) checks the step's tensors at once against the plan,
    allocates the new table and launches once: the trace `e` (B, S, A) for
    control, with actions `a`, or (B, S) for prediction, with `a` None, is
    updated IN PLACE. `s`, `a` int32, `delta` float32 and `cut` bool are
    (B,)."""

    def __init__(self, table, batch: int, with_actions: bool):
        self.device = table.device
        self.batch = check_int("batch", batch, low=1)
        self.table_shape = tuple(table.shape)
        if table.dim() != (2 if with_actions else 1):
            raise ValueError(f"a {'control' if with_actions else 'prediction'} table cannot have shape "
                             f"{self.table_shape}")
        self.n_cells = check_int("cells", table.numel(), low=1)
        self.num_actions = int(table.shape[-1]) if with_actions else 1
        self.words = scratch_words(self.batch, self.n_cells)
        sms = torch.cuda.get_device_properties(self.device).multi_processor_count if self.device.type == "cuda" else 1
        self.appliers = appliers(self.n_cells, sms)
        self._scratch = torch.zeros(sum(self.words.values()), dtype=torch.int32, device=self.device)
        base = self._scratch.data_ptr()
        self._scratch_ptrs = (base, base + 4 * self.words["partial"],
                              base + 4 * (self.words["partial"] + self.words["count"]))
        b, dev = self.batch, self.device
        # (dtype, shape, device, contiguous) of table, e, s, a, delta, cut
        self._expected = [(dtype, torch.Size(shape), dev, True) for dtype, shape in (
            (torch.float32, self.table_shape), (torch.float32, (b, *self.table_shape)), (torch.int32, (b,)),
            (torch.int32, (b,)), (torch.float32, (b,)), (torch.bool, (b,)))]
        if not with_actions:
            self._expected[3] = None
        self._stream = torch._C._cuda_getCurrentRawStream(dev.index) if dev.type == "cuda" else None

    def check(self, tensors) -> None:
        """One check of the step's tensors (table, e, s, a, delta, cut)
        against the plan; on a mismatch, the tensor at fault is named."""
        try:
            if [None if x is None else (x.dtype, x.shape, x.device, x.is_contiguous())
                    for x in tensors] == self._expected:
                return
        except AttributeError:
            pass
        for name, x, want in zip(("table", "e", "s", "a", "delta", "cut"), tensors, self._expected):
            if want is None:
                if x is not None:
                    raise ValueError("a prediction plan takes no actions")
                continue
            if x is None:
                raise ValueError(f"{name} is None")
            check_tensor(name, x, want[0], want[1], want[2])
        raise ValueError("K12's step tensors do not match the plan")

    def __call__(self, table, e, s, a, delta, cut, gamma_lam: float, cutoff: float, alpha: float,
                 replacing: bool):
        """One trace step (see the class docstring): one launch. Returns the new table."""
        self.check((table, e, s, a, delta, cut))
        if self._stream is None:
            raise ValueError(f"K12 takes CUDA tensors, got {self.device}")
        if torch._C._cuda_getCurrentRawStream(self.device.index) != self._stream:
            raise RuntimeError("a TracePassPlan is stream-ordered: it was called from another stream than "
                               "the one it was built on")
        table_out = torch.empty(self.table_shape, dtype=torch.float32, device=self.device)
        launch("gu_trace_pass", self.device, e.data_ptr(), s.data_ptr(), None if a is None else a.data_ptr(),
               delta.data_ptr(), cut.data_ptr(), table.data_ptr(), table_out.data_ptr(), float(gamma_lam),
               float(cutoff), float(alpha), int(bool(replacing)), self.num_actions, self.batch, self.n_cells,
               self.appliers, *self._scratch_ptrs)
        LAUNCHES["trace_pass"] += 1
        return table_out


def trace_pass_cuda(table, e, s, a, delta, cut, gamma_lam: float, cutoff: float, alpha: float,
                    replacing: bool, plan: TracePassPlan | None = None):
    """Launch K12 once through `plan` (a loop builds its plan once; without
    one, a plan built for the call): one step of the trace `e`, updated IN
    PLACE. Returns the new table."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"trace_pass_cuda takes CUDA tensors, got {device}")
    if plan is None:
        plan = TracePassPlan(table, int(e.shape[0]), a is not None)
    return plan(table, e, s, a, delta, cut, gamma_lam, cutoff, alpha, replacing)


def padded_chunks(chunks: int) -> int:
    """Rows of partial sums the apply reads: `chunks` up to a multiple of
    APPLY_CHUNKS (`padded_chunks` in the source), the rows past `chunks` 0."""
    return -(-chunks // APPLY_CHUNKS) * APPLY_CHUNKS


class TracePartialsPlan:
    """K12's partial-sums form for one run of a rank of a sharded TD(λ)
    learner: a trace of `batch` envs (the rank's), a table replicated over
    `ranks` ranks. A step is two launches: `partials` (decay, flush, bump,
    the cut, each chunk of CHUNK envs' Σ δ·e a cell into `local` and the
    live counts into `count`), then, once the caller has gathered every
    rank's `local` in rank order into `gathered`'s first rows and summed
    `count` over the ranks in place, `apply` (the gathered chunks added in
    order from 0.0, `table + α·num / max(count, 1)`, `count` set back to 0).

    `gathered` holds `ranks` × the rank's chunks, zero-padded to
    `padded_chunks` rows; with `own_rows` the rank's pass writes straight
    into its first rows (a world of one without a collective), else into a
    buffer of its own. Stream-ordered like `TracePassPlan`: the count is
    zeroed once, and each apply leaves it 0."""

    def __init__(self, table, batch: int, with_actions: bool, ranks: int = 1, own_rows: bool = False):
        self.device = table.device
        if self.device.type != "cuda":
            raise ValueError(f"K12's partial-sums form takes CUDA tensors, got {self.device}")
        self.batch = check_int("batch", batch, low=1)
        self.ranks = check_int("ranks", ranks, low=1)
        self.table_shape = tuple(table.shape)
        if table.dim() != (2 if with_actions else 1):
            raise ValueError(f"a {'control' if with_actions else 'prediction'} table cannot have shape "
                             f"{self.table_shape}")
        self.n_cells = check_int("cells", table.numel(), low=1)
        self.num_actions = int(table.shape[-1]) if with_actions else 1
        self.chunks = -(-self.batch // CHUNK)
        self.total_chunks = check_int("chunks", self.chunks * self.ranks, low=1)
        scratch_words(self.batch, self.n_cells)  # the grid's limit
        rows = padded_chunks(self.total_chunks)
        self.gathered = torch.zeros((rows, self.n_cells), dtype=torch.float32, device=self.device)
        if own_rows and self.ranks == 1:
            self.local = self.gathered[: self.chunks]
        else:
            self.local = torch.zeros((self.chunks, self.n_cells), dtype=torch.float32, device=self.device)
        self.count = torch.zeros(self.n_cells, dtype=torch.int32, device=self.device)
        b, dev = self.batch, self.device
        self._expected = [(dtype, torch.Size(shape), dev, True) for dtype, shape in (
            (torch.float32, (b, *self.table_shape)), (torch.int32, (b,)), (torch.int32, (b,)),
            (torch.float32, (b,)), (torch.bool, (b,)))]
        if not with_actions:
            self._expected[2] = None
        self._stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def _on_stream(self) -> None:
        if torch._C._cuda_getCurrentRawStream(self.device.index) != self._stream:
            raise RuntimeError("a TracePartialsPlan is stream-ordered: it was called from another stream than "
                               "the one it was built on")

    def partials(self, e, s, a, delta, cut, gamma_lam: float, cutoff: float, replacing: bool):
        """The pass (one launch): `e` updated IN PLACE; returns (local (chunks,
        cells) partial sums, count (cells,) int32), the plan's buffers."""
        tensors = (e, s, a, delta, cut)
        if [None if x is None else (x.dtype, x.shape, x.device, x.is_contiguous())
                for x in tensors] != self._expected:
            for name, x, want in zip(("e", "s", "a", "delta", "cut"), tensors, self._expected):
                if want is None:
                    if x is not None:
                        raise ValueError("a prediction plan takes no actions")
                    continue
                if x is None:
                    raise ValueError(f"{name} is None")
                check_tensor(name, x, want[0], want[1], want[2])
            raise ValueError("K12's partial-sums step tensors do not match the plan")
        self._on_stream()
        launch("gu_trace_partials", self.device, e.data_ptr(), s.data_ptr(), None if a is None else a.data_ptr(),
               delta.data_ptr(), cut.data_ptr(), float(gamma_lam), float(cutoff), int(bool(replacing)),
               self.num_actions, self.batch, self.n_cells, self.local.data_ptr(), self.count.data_ptr())
        LAUNCHES["trace_partials"] += 1
        return self.local, self.count

    def apply(self, table, alpha: float):
        """The apply (one launch) over `gathered`'s first `total_chunks` rows
        and `count`: returns the new table; `count` is left 0."""
        check_tensor("table", table, torch.float32, self.table_shape, self.device)
        self._on_stream()
        out = torch.empty(self.table_shape, dtype=torch.float32, device=self.device)
        launch("gu_trace_apply", self.device, self.gathered.data_ptr(), self.count.data_ptr(), table.data_ptr(),
               out.data_ptr(), float(alpha), self.n_cells, self.total_chunks)
        LAUNCHES["trace_partials"] += 1
        return out
