"""The device YCSB generator on the CPU: frequencies against the exact
bounded zipfian, the scramble, and the seed."""

import pytest
import torch

from portbench import ycsb

N = 64
DRAWS = 400_000


@pytest.mark.parametrize("s", [0.5, 0.99, 2.0])
def test_rank_frequencies_match_the_exact_bounded_zipf(s):
    gen = ycsb.generator(3, "cpu")
    z = ycsb.Zipf(N, s, gen)
    counts = torch.bincount(z.ranks(DRAWS, gen), minlength=N).double()
    p = ycsb.exact_probabilities(N, s)
    emp = counts / DRAWS
    sigma = (p * (1 - p) / DRAWS).sqrt()
    assert counts.numel() == N
    assert float(((emp - p).abs() / sigma).max()) < 5.0
    assert float((emp - p).abs().sum()) / 2 < 0.01


def test_keys_are_the_ranks_through_the_scramble():
    gen = ycsb.generator(11, "cpu")
    z = ycsb.Zipf(N, 0.99, gen)
    assert torch.equal(torch.sort(z.scramble.long()).values,
                       torch.arange(N))
    g1, g2 = ycsb.generator(5, "cpu"), ycsb.generator(5, "cpu")
    ranks = z.ranks(1000, g1)
    assert torch.equal(z.keys(1000, g2), z.scramble[ranks])
    counts = torch.bincount(z.keys(DRAWS, g1).long(), minlength=N).double()
    p = ycsb.exact_probabilities(N, 0.99)
    assert float((counts[z.scramble.long()] / DRAWS - p).abs().max()) < 0.01


def test_the_cdf_ends_at_one_and_the_probabilities_sum_to_one():
    cdf = ycsb.zipf_cdf(1000, 0.99, "cpu")
    assert float(cdf[-1]) == 1.0
    assert bool((cdf[1:] >= cdf[:-1]).all())
    assert abs(float(ycsb.exact_probabilities(1000, 0.5).sum()) - 1) < 1e-12


def _batches(seed):
    gen = ycsb.generator(seed, "cpu")
    z = ycsb.Zipf(1 << 12, 0.99, gen)
    return z.scramble, [z.keys(256, gen) for _ in range(4)]


@pytest.mark.parametrize("seed", [0, 2147483901, 2**33 + 5])
def test_the_same_seed_gives_the_same_batches(seed):
    s1, b1 = _batches(seed)
    s2, b2 = _batches(seed)
    assert torch.equal(s1, s2)
    assert all(torch.equal(x, y) for x, y in zip(b1, b2))
    s3, b3 = _batches(seed + 1)
    assert not torch.equal(s1, s3)
    assert not all(torch.equal(x, y) for x, y in zip(b1, b3))
