"""The device draws of positive-weight rows (``parallel.sharding.
permuted_draws``), the one engine of the host loop's refill on a dataset
without a host copy and of the device loop's refill table.

Its properties are exact, so the checks are: a permutation of ``[0, P)``
with no repeats, draw j the same however many are drawn, only rows of
positive weight, and the same rows for the same seed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import (  # noqa: E402
    PERMUTE_STEPS, draw_keys, permuted_draws, to_device)


def _keys(*seed):
    return torch.from_numpy(draw_keys(list(seed)))


@pytest.mark.parametrize("n_pos", [1, 2, 3, 5, 16, 17, 100, 1023, 4097])
def test_draws_are_a_permutation(n_pos):
    for seed in range(3):
        got = permuted_draws(n_pos, torch.arange(n_pos + 4),
                             _keys(seed, n_pos))
        assert torch.equal(torch.sort(got[:n_pos]).values,
                           torch.arange(n_pos))
        assert (got[n_pos:] == -1).all()         # the candidates used up


def test_draw_j_does_not_depend_on_how_many_are_drawn():
    keys = _keys(42, 3)
    many = permuted_draws(100_003, torch.arange(500), keys)
    few = permuted_draws(100_003, torch.arange(7), keys)
    assert torch.equal(many[:7], few)
    assert len(set(many.tolist())) == 500
    table = permuted_draws(100_003, torch.arange(500).expand(2, 500),
                           torch.stack([keys, _keys(42, 4)]))
    assert torch.equal(table[0], many)
    assert torch.equal(table[1], permuted_draws(100_003, torch.arange(500),
                                                _keys(42, 4)))


def test_draws_stay_in_range_at_large_counts():
    """Every product of the hash is of a 31-bit value and a 30-bit
    constant: no int64 overflow at the largest candidate counts."""
    n_pos = (1 << 40) - 3
    got = permuted_draws(n_pos, torch.arange(2000), _keys(1))
    assert ((got >= 0) & (got < n_pos)).all()
    assert len(set(got.tolist())) == 2000
    assert draw_keys([1]).shape == (PERMUTE_STEPS,)
    assert (draw_keys([1]) < 2 ** 31).all()


def test_the_first_draw_is_uniform():
    counts = np.zeros(10)
    for seed in range(4000):
        counts[int(permuted_draws(10, torch.arange(1), _keys(seed))[0])] += 1
    assert counts.min() > 320 and counts.max() < 480    # 400 expected


def test_hostless_dataset_draws_positive_rows_the_same_per_seed():
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.float32))
    w = np.ones(300)
    w[::4] = 0.0
    ds = to_device(X, torch.device("cpu"), np.float32, sample_weight=w)
    assert ds.host is None
    rows = ds.sample_positive_rows(20, [42, 1])
    index = [int(np.flatnonzero((X.numpy() == r).all(1))[0]) for r in rows]
    assert len(set(index)) == 20 and all(w[i] > 0 for i in index)
    np.testing.assert_array_equal(ds.sample_positive_rows(20, [42, 1]), rows)
    assert not np.array_equal(ds.sample_positive_rows(20, [42, 2]), rows)
    np.testing.assert_array_equal(ds.sample_positive_rows(5, [42, 1]),
                                  rows[:5])
    assert ds.sample_positive_rows(1000, [3]).shape == (225, 4)


def test_refill_table_is_the_host_loops_draws():
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal((200, 3)))
    w = rng.random(200)
    w[:30] = 0.0
    ds = to_device(X, torch.device("cpu"), np.float64, sample_weight=w)
    table = dist.refill_table(ds, dist.empty_draw_keys(9, 4), k=6)
    assert table.shape == (4, 6)
    for it in range(4):
        rows = ds.sample_positive_rows(6, [9, it + 1])
        np.testing.assert_array_equal(ds.gather_positive(table[it]).numpy(),
                                      rows)
    few = to_device(X[:3], torch.device("cpu"), np.float64,
                    sample_weight=[1.0, 0.0, 1.0])
    small = dist.refill_table(few, dist.empty_draw_keys(9, 2), k=4)
    assert sorted(small[0, :2].tolist()) == [0, 1]   # positive rows 0 and 2
    assert sorted(few.gather_positive(small[0, :2])[:, 0].tolist()) == \
        sorted(X[[0, 2], 0].tolist())
    assert (small[:, 2:] == -1).all()
