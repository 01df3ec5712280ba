"""Port parity: the replay ring (K8b) and the prioritized draw (K8a) of
griduniverse_tpu_torch.models.dqn on the CPU, where the wrappers take the
plain PyTorch versions, against the JAX functions.

`prioritized_sample` is fed `jax.random`'s own Gumbel draws. Its slot
indices must equal the reference's wherever the scores around the cut and
between neighbours in the order are apart by more than 4 ulp (XLA fuses
`α·log p + g` into one rounding, torch rounds twice); its weights agree to
rtol 1e-6. The ring's write, gather and refresh are integer or copy
operations and must be equal exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from griduniverse_tpu.models import dqn as jdqn
from griduniverse_tpu_torch.kernels import replay as k8
from griduniverse_tpu_torch.models import dqn as tdqn

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def jax_gumbel(key, cap):
    """The noise `jdqn.prioritized_sample(prio, key, ...)` draws."""
    return _t(jax.random.gumbel(key, (cap,)))


def well_separated(prio, noise, size, n, alpha, ulps=4):
    """True if the n + 1 best scores are pairwise more than `ulps` apart,
    so that one rounding cannot reorder them."""
    score, _ = tdqn.per_scores_reference(_t(prio), noise, torch.tensor(size), alpha)
    top = torch.sort(score, descending=True).values[: n + 1]
    top = top[torch.isfinite(top)]
    gap = (top[:-1] - top[1:]).abs()
    return bool((gap > ulps * 2.0 ** -23 * top[:-1].abs().clamp(min=1.0)).all())


# ---------------------------------------------------------------------------
# K8b: write, gather, refresh
# ---------------------------------------------------------------------------


def _batch(mod, xp, v, b=4):
    if xp is jnp:
        return mod.ReplayBuffer(
            obs=jnp.full(b, v, jnp.int32), action=jnp.full(b, v, jnp.int32),
            reward=jnp.full(b, float(v), jnp.float32), next_obs=jnp.full(b, v, jnp.int32),
            done=jnp.zeros(b, bool))
    return mod.ReplayBuffer(
        obs=torch.full((b,), v, dtype=torch.int32), action=torch.full((b,), v, dtype=torch.int32),
        reward=torch.full((b,), float(v)), next_obs=torch.full((b,), v, dtype=torch.int32),
        done=torch.zeros(b, dtype=torch.bool))


def test_replay_buffer_circular_writes():
    """Three writes of 4 into capacity 8: the third wraps onto slot 0, as
    the reference's test of the same name."""
    jbuf, tbuf = jdqn.buffer_init(8), tdqn.buffer_init(8, device=CPU)
    for t, v in enumerate([1, 2, 3]):
        jbuf = jdqn.buffer_write(jbuf, jnp.int32((t * 4) % 8), _batch(jdqn, jnp, v))
        tbuf = tdqn.buffer_write(tbuf, (t * 4) % 8, _batch(tdqn, torch, v))
    assert tbuf.obs.tolist() == [3, 3, 3, 3, 2, 2, 2, 2]
    for tf, jf in zip(tbuf, jbuf):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    mb = tdqn.buffer_sample(tbuf, torch.Generator().manual_seed(0), 8, 32)
    assert set(mb.obs.tolist()) <= {2, 3} and mb.reward.shape == (32,)


@pytest.mark.parametrize("at", [0, 6, 10])
def test_write_with_priority_fill_matches_jax(rng, at):
    cap, b = 16, 6
    fields = [rng.integers(0, 50, cap).astype(np.int32), rng.integers(0, 4, cap).astype(np.int32),
              rng.normal(size=cap).astype(np.float32), rng.integers(0, 50, cap).astype(np.int32),
              rng.random(cap) < 0.3]
    new = [rng.integers(0, 50, b).astype(np.int32), rng.integers(0, 4, b).astype(np.int32),
           rng.normal(size=b).astype(np.float32), rng.integers(0, 50, b).astype(np.int32),
           rng.random(b) < 0.3]
    prio = rng.random(cap).astype(np.float32)
    jbuf = jdqn.buffer_write(jdqn.ReplayBuffer(*map(jnp.asarray, fields)), jnp.int32(at),
                             jdqn.ReplayBuffer(*map(jnp.asarray, new)))
    jprio = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(prio), jnp.full((b,), 2.5, jnp.float32), at, 0)
    tbuf = tdqn.ReplayBuffer(*map(_t, fields))
    tprio = _t(prio)
    out = tdqn.buffer_write(tbuf, torch.tensor(at), tdqn.ReplayBuffer(*map(_t, new)), tprio, torch.tensor(2.5))
    assert out is tbuf  # in place
    for tf, jf in zip(tbuf, jbuf):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tprio.numpy(), np.asarray(jprio))


@pytest.mark.parametrize("cap,n", [(64, 40), (8192, 4096)])
def test_gather_matches_jax(rng, cap, n):
    fields = [rng.integers(0, 50, cap).astype(np.int32), rng.integers(0, 4, cap).astype(np.int32),
              rng.normal(size=cap).astype(np.float32), rng.integers(0, 50, cap).astype(np.int32),
              rng.random(cap) < 0.3]
    idx = rng.integers(0, cap, n).astype(np.int32)
    want = jax.tree.map(lambda x: x[jnp.asarray(idx)], jdqn.ReplayBuffer(*map(jnp.asarray, fields)))
    got = tdqn.replay_gather(tdqn.ReplayBuffer(*map(_t, fields)), _t(idx))
    for tf, jf in zip(got, want):
        assert tf.dtype == _t(np.asarray(jf)).dtype and tf.shape == (n,)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("cap,n,span", [(32, 24, 6), (4096, 1500, 300)])
def test_refresh_with_equal_indices_matches_jax(rng, cap, n, span):
    """`prio.at[idx].set(new)` with equal indices: XLA's CPU scatter applies
    the rows in order, so the highest position wins; the port fixes that
    winner. The second shape is above the one-block scan of 1,024 rows."""
    prio = rng.random(cap).astype(np.float32)
    idx = rng.integers(0, span, n).astype(np.int32)  # heavy collisions
    idx[-1] = idx[0]
    abs_err = rng.random(n).astype(np.float32) * 3
    new_p = jnp.asarray(abs_err) + 1e-3
    want = jnp.asarray(prio).at[jnp.asarray(idx)].set(new_p)
    want_max = jnp.maximum(jnp.float32(1.0), jnp.max(new_p))
    tprio = _t(prio)
    p_max = tdqn.prio_refresh(tprio, _t(idx), _t(abs_err), 1e-3, torch.tensor(1.0))
    np.testing.assert_array_equal(tprio.numpy(), np.asarray(want))
    assert float(p_max) == float(want_max)
    last = {int(s): i for i, s in enumerate(idx)}  # the highest position of each slot
    for slot, i in last.items():
        assert tprio[slot] == torch.tensor(abs_err[i]) + 1e-3


@pytest.mark.parametrize("n,launches", [(1, 1), (1024, 1), (1025, 1), (8192, 1), (8193, 2), (131_072, 2)])
def test_refresh_launches_one_kernel_up_to_the_hash_table_limit(n, launches):
    """On the card a refresh of up to 8,192 rows is one launch (up to 1,024
    rows one block scanning the later rows, above that a cluster of eight
    blocks of 1,024 threads, a row a thread, over a hash table of 2n
    entries); above it, two launches."""
    assert k8.refresh_launches(n) == launches
    assert k8.MAX_HASH_REFRESH == 8 * 1024


# ---------------------------------------------------------------------------
# K8a: the prioritized draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap,size,n,alpha,beta", [
    (512, 512, 32, 0.6, 0.4), (512, 300, 32, 1.0, 1.0), (256, 256, 64, 0.6, 0.7), (64, 64, 64, 0.6, 0.4),
])
def test_prioritized_sample_matches_jax(rng, cap, size, n, alpha, beta):
    checked = 0
    for seed in range(6):
        prio = (rng.random(cap).astype(np.float32) * 5 + 1e-3)
        prio[rng.integers(0, cap, 5)] = 0.0  # slots without mass inside the valid region
        key = jax.random.PRNGKey(seed)
        jidx, jw = jdqn.prioritized_sample(jnp.asarray(prio), key, jnp.asarray(size), n, alpha, jnp.float32(beta))
        noise = jax_gumbel(key, cap)
        tidx, tw = tdqn.prioritized_sample(_t(prio), noise, size, n, alpha, beta)
        assert tidx.dtype == torch.int32 and tw.dtype == torch.float32
        if not well_separated(prio, noise, size, min(n, cap - 1), alpha):
            continue
        checked += 1
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert checked >= 4


def test_size_smaller_than_n_falls_back_by_lowest_index():
    """size < n sends −inf slots into the pick: they come out by lowest
    index after the valid ones, every one takes the fallback hash at weight
    exactly 1, as in the reference."""
    cap, size, n = 32, 5, 12
    prio = np.ones(cap, np.float32)
    key = jax.random.PRNGKey(3)
    jidx, jw = jdqn.prioritized_sample(jnp.asarray(prio), key, jnp.asarray(size), n, 0.6, jnp.float32(0.5))
    noise = jax_gumbel(key, cap)
    score, pa = tdqn.per_scores_reference(_t(prio), noise, torch.tensor(size), 0.6)
    raw = torch.sort(score, descending=True, stable=True).indices[:n]
    assert raw[size:].tolist() == list(range(size, n))  # the −inf slots, lowest index first
    tidx, tw = tdqn.prioritized_sample(_t(prio), noise, size, n, 0.6, 0.5)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert (tidx < size).all() and (tw[size:] == 1.0).all()
    h = (np.arange(size, n, dtype=np.uint64) * 2654435761 + np.arange(size, n, dtype=np.uint64)) % 2**32
    assert tidx[size:].tolist() == (h % size).tolist()


@pytest.mark.parametrize("kind", ["random", "all equal", "size < n"])
@pytest.mark.parametrize("n", [1, 256, 4096, 8192])
def test_prioritized_sample_matches_jax_at_the_sort_limits(monkeypatch, rng, n, kind):
    """One pick, 256, 4,096 and the whole ring of 8,192. The priorities are
    1 or 0, so every score of a slot with priority 1 is its Gumbel draw
    exactly, whatever the rounding, and the picks must equal the
    reference's, score for score. Where the reference leaves equal scores
    in an order of its own (equal draws, every score equal, the -inf slots
    past `size`), the port takes them by lowest index, and the weights
    must agree."""
    cap = 8192
    prio = np.ones(cap, np.float32)
    prio[rng.integers(0, cap, 64)] = 0.0  # scores far below the rest, still with mass
    size = cap if n == cap else cap // 2 + 37
    if kind == "all equal":
        prio[:] = 1.0
        monkeypatch.setattr(jax.random, "gumbel", lambda key, shape: jnp.zeros(shape, jnp.float32))
    elif kind == "size < n":
        size = n // 2
    key = jax.random.PRNGKey(n)
    jidx, jw = jdqn.prioritized_sample(jnp.asarray(prio), key, jnp.asarray(size), n, 0.6, jnp.float32(0.4))
    jidx, jw = np.asarray(jidx), np.asarray(jw)
    noise = jax_gumbel(key, cap)
    tidx, tw = tdqn.prioritized_sample(_t(prio), noise, size, n, 0.6, 0.4)
    assert tidx.shape == (n,) and tw.shape == (n,)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-6)
    if kind == "all equal":
        assert tidx.tolist() == list(range(n)) and (tw == 1.0).all()
        return
    valid = min(size, n)
    score = tdqn.per_scores_reference(_t(prio), noise, torch.tensor(size), 0.6)[0].numpy()
    got, want = tidx.numpy()[:valid], jidx[:valid]
    np.testing.assert_array_equal(score[got], score[want])  # the same scores in the same order
    np.testing.assert_array_equal(np.sort(got), np.sort(want))  # the same slots
    tied = score[got][1:] == score[got][:-1]
    assert (got[1:][tied] > got[:-1][tied]).all()  # equal scores by lowest index
    if size < n:  # the -inf slots by lowest index, each replaced by the hash at weight 1
        h = (np.arange(size, n, dtype=np.uint64) * 2654435761 + np.arange(size, n, dtype=np.uint64)) % 2**32
        assert tidx[size:].tolist() == (h % max(size, 1)).tolist()
        assert (tw[size:] == 1.0).all() and (jw[size:] == 1.0).all()


def test_sampling_frequency_tracks_priority():
    """8 slots, one slot 20x the priority of the rest, alpha=1 (the
    reference's test of the same name)."""
    prio = torch.tensor([1, 1, 1, 20, 1, 1, 1, 1], dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(8)
    for _ in range(600):
        noise = tdqn.draw_gumbel(gen, (8,), CPU)
        idx, _ = tdqn.prioritized_sample(prio, noise, 8, 1, 1.0, 0.4)
        counts[int(idx[0])] += 1
    assert counts[3] / 600 > 0.55  # expected share of slot 3: 20/27 ≈ 0.74
    assert (counts > 0).all()      # every slot reachable


def test_uniform_priorities_give_unit_weights():
    prio = torch.ones(16)
    noise = jax_gumbel(jax.random.PRNGKey(0), 16)
    idx, w = tdqn.prioritized_sample(prio, noise, 16, 4, 0.6, 1.0)
    np.testing.assert_allclose(w.numpy(), 1.0, rtol=1e-6)
    assert len(set(idx.tolist())) == 4  # without replacement


def test_invalid_slots_never_sampled():
    prio = torch.ones(32)
    for i in range(20):
        noise = jax_gumbel(jax.random.PRNGKey(i), 32)
        idx, _ = tdqn.prioritized_sample(prio, noise, 5, 4, 0.6, 1.0)
        assert (idx < 5).all()


def test_equal_scores_go_to_the_lowest_index():
    """The tie rule the kernel follows: equal scores by lowest index, in
    the order of a stable descending sort."""
    prio = torch.ones(16)
    noise = torch.zeros(16)
    noise[[3, 9]] = 1.0
    idx, w = tdqn.prioritized_sample(prio, noise, 16, 6, 0.6, 0.4)
    assert idx.tolist() == [3, 9, 0, 1, 2, 4]
    assert (w == 1.0).all()


def test_buffer_sample_idx_stays_in_the_valid_region():
    gen = torch.Generator().manual_seed(1)
    for size in (0, 1, 7, 1000):
        idx = tdqn.buffer_sample_idx(gen, torch.tensor(size), 256)
        assert idx.dtype == torch.int32 and idx.shape == (256,)
        assert (idx >= 0).all() and (idx < max(size, 1)).all()
    idx = tdqn.buffer_sample_idx(gen, 1000, 4096)
    assert len(set(idx.tolist())) > 900  # spread over the region
