"""The port's DTW (`crlot_tpu_torch.align`) on the CPU.

Mirrors `tests/test_align.py` case for case with its gates (the
accumulated matrix within rtol 1e-5 / atol 1e-4 of a float64 sequential
DP on the same costs, the cost within 1e-3, the path's geometry, the
near-zero floor of identical sequences), then holds the port against the
reference on the same seeded input:

- `_minplus_row` given the same previous row and costs: equal value for
  value (it is `jax.lax.associative_scan`'s recursion step for step; the
  mins are exact and each add rounds in the same order);
- `dtw_cost` within 1e-5 of the largest distance (the products' summation
  orders differ; the reference notes a 1e-3 absolute floor near zero);
- `dtw`: every row after the first, from the reference's previous row and
  costs, equal to the reference's row; row 0 is a cumsum that XLA's CPU
  sums in its own blocked order (a reduce-window rewritten by XLA), so the
  accumulated matrix from each package's own costs is held within
  (i + j + 1) times the cost bound plus 4 ulp of its magnitude (a path to
  (i, j) adds at most i + j + 1 costs; measured 1.2e-7 relative), and the
  paths are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crlot_tpu.align as ja

from crlot_tpu_torch.align import _minplus_row, dtw, dtw_cost, dtw_path

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtw_oracle(c):
    """Classic O(N*M) sequential dynamic program."""
    n, m = c.shape
    d = np.full((n, m), np.inf)
    d[0, 0] = c[0, 0]
    for j in range(1, m):
        d[0, j] = d[0, j - 1] + c[0, j]
    for i in range(1, n):
        d[i, 0] = d[i - 1, 0] + c[i, 0]
        for j in range(1, m):
            d[i, j] = c[i, j] + min(d[i - 1, j], d[i, j - 1], d[i - 1, j - 1])
    return d


# ---------------------------------------------------------------------------
# mirrors of tests/test_align.py
# ---------------------------------------------------------------------------

def test_acc_matrix_matches_oracle():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((17, 5)).astype(np.float32)
    y = rng.standard_normal((23, 5)).astype(np.float32)
    cost, acc = dtw(x, y, device=CPU)
    c = dtw_cost(x, y, device=CPU).numpy()
    want = _dtw_oracle(c.astype(np.float64))
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-5, atol=1e-4)
    assert abs(float(cost) - want[-1, -1]) < 1e-3


def test_identical_sequences_zero_cost_diagonal_path():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    cost, acc = dtw(x, x, device=CPU)
    assert float(cost) < 0.05
    assert dtw_path(acc) == [(i, i) for i in range(20)]


def test_path_endpoints_and_monotonicity():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 3)).astype(np.float32)
    y = rng.standard_normal((30, 3)).astype(np.float32)
    _, acc = dtw(x, y, device=CPU)
    path = dtw_path(acc)
    assert path[0] == (0, 0) and path[-1] == (11, 29)
    steps = set(
        (b[0] - a[0], b[1] - a[1]) for a, b in zip(path[:-1], path[1:])
    )
    assert steps <= {(1, 0), (0, 1), (1, 1)}


def test_time_shifted_tone_aligns_with_offset():
    n, d = 40, 8
    rng = np.random.default_rng(3)
    base = rng.standard_normal((n + 5, d)).astype(np.float32)
    x, y = base[:n], base[5 : n + 5]
    _, acc = dtw(x, y, device=CPU)
    path = dtw_path(acc)
    mid = [p for p in path if 10 <= p[0] <= n - 10]
    frac = np.mean([1.0 if j == i - 5 else 0.0 for i, j in mid])
    assert frac > 0.8, (frac, mid[:10])


def test_cosine_metric():
    x = np.eye(4, dtype=np.float32)
    c = dtw_cost(x, x, metric="cosine", device=CPU).numpy()
    np.testing.assert_allclose(np.diag(c), 0.0, atol=1e-6)
    assert np.all(c[~np.eye(4, dtype=bool)] > 0.9)


def test_unknown_metric_raises():
    with pytest.raises(ValueError):
        dtw_cost(torch.ones((3, 2)), torch.ones((3, 2)), metric="manhattan")


def test_1d_inputs_promoted():
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal(10).astype(np.float32))
    cost, acc = dtw(x[:, None], x[:, None])
    assert float(cost) < 0.05


def test_1d_series_treated_as_scalar_features():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(12).astype(np.float32)
    y = np.concatenate([x[:3], x]).astype(np.float32)
    assert dtw_cost(x, y, device=CPU).shape == (12, 15)
    cost, acc = dtw(x, y, device=CPU)
    assert acc.shape == (12, 15)
    assert np.isfinite(float(cost))
    cost_same, _ = dtw(x, x, device=CPU)
    assert float(cost_same) < 1e-3


def test_rank3_input_raises():
    with pytest.raises(ValueError, match="expected"):
        dtw_cost(torch.ones((2, 3, 4)), torch.ones((3, 4)))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 7, 64, 333])
def test_minplus_row_equals_reference(m):
    rng = np.random.default_rng(60 + m)
    prev = np.cumsum(rng.uniform(0, 3, m)).astype(np.float32)
    row = rng.uniform(0, 3, m).astype(np.float32)
    got = _minplus_row(torch.from_numpy(prev), torch.from_numpy(row))
    want = ja._minplus_row(jnp.asarray(prev), jnp.asarray(row))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_dtw_matches_reference(metric):
    rng = np.random.default_rng(61)
    x = rng.standard_normal((57, 12)).astype(np.float32)
    y = np.concatenate([x[::2], x[20:]]).astype(np.float32)
    y = (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    c = dtw_cost(x, y, metric=metric, device=CPU).numpy()
    jc = np.asarray(ja.dtw_cost(jnp.asarray(x), jnp.asarray(y),
                                metric=metric))
    assert np.max(np.abs(c - jc)) <= 1e-5 * np.max(np.abs(jc))
    cost, acc = dtw(x, y, metric=metric, device=CPU)
    jcost, jacc = ja.dtw(x, y, metric=metric)
    jacc = np.asarray(jacc)
    i, j = np.indices(jacc.shape)
    steps = (i + j + 1) * 1e-5 * np.max(np.abs(jc))
    assert np.all(np.abs(acc.numpy() - jacc)
                  <= steps + 2.0 ** -21 * np.abs(jacc))
    assert dtw_path(acc) == ja.dtw_path(jacc)


def test_rows_equal_reference_given_its_costs():
    """Every row after the first, from the reference's previous row and
    costs, equals the reference's row."""
    rng = np.random.default_rng(62)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    y = rng.standard_normal((41, 6)).astype(np.float32)
    jc = np.asarray(ja.dtw_cost(jnp.asarray(x), jnp.asarray(y)))
    _, jacc = ja.dtw(x, y)
    jacc = np.asarray(jacc)
    for i in range(1, jacc.shape[0]):
        got = _minplus_row(torch.from_numpy(jacc[i - 1].copy()),
                           torch.from_numpy(jc[i].copy()))
        assert np.array_equal(got.numpy(), jacc[i]), i


def test_dtw_path_takes_the_reference_matrix():
    rng = np.random.default_rng(63)
    acc = np.cumsum(rng.uniform(0, 1, (9, 13)), axis=1).astype(np.float32)
    acc[4, 6] = acc[3, 5]  # a tie: the diagonal wins
    assert dtw_path(acc) == ja.dtw_path(acc)
    assert dtw_path(torch.from_numpy(acc)) == ja.dtw_path(acc)
