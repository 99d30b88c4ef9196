"""Traffic from the seed: arrivals and batches repeat exactly, and the
arrivals keep the file's rate."""

import math

import numpy as np
import pytest

from port_bench.traffic import serve_open_loop as so
from port_bench.traffic import train_loop as tl


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 4_000_000_017])
def test_arrivals_repeat_and_keep_the_rate(seed):
    rate, seconds = 5.0, 45.0
    a, b = so.arrivals(rate, seconds, seed), so.arrivals(rate, seconds, seed)
    assert np.array_equal(a, b)
    assert len(a) == round(rate * seconds)
    assert np.all(np.diff(a) > 0) and a[-1] == pytest.approx(seconds)
    # the mean gap, against a Poisson stream's sampling error of it
    n = len(a)
    mean_rate = n / a[-1]
    assert abs(mean_rate - rate) <= 3 * rate / math.sqrt(n)
    other = so.arrivals(rate, seconds, seed + 1)
    assert not np.array_equal(a, other)
    # the same set of gaps, another order
    assert np.allclose(np.sort(np.diff(np.r_[0, a])),
                       np.sort(np.diff(np.r_[0, other])))


def test_token_batches_repeat_and_differ_by_step():
    d = tl.TokenBatches(2**33 + 1, 2, 16, 100)
    x, y = d.batch_at(3), d.batch_at(3)
    assert np.array_equal(x["tokens"], y["tokens"])
    assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not np.array_equal(x["tokens"], d.batch_at(4)["tokens"])
    assert not np.array_equal(x["tokens"][0], x["tokens"][1])


def test_sample_is_drawn_from_the_seed():
    served = {i: 0 for i in range(100)}
    assert so.sample(served, 8, 3) == so.sample(served, 8, 3)
    assert len(set(so.sample(served, 8, 3))) == 8
    assert so.sample(served, 8, 3) != so.sample(served, 8, 4)
