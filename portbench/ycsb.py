"""YCSB key popularity on the device: a bounded zipfian by inverse CDF,
scrambled by a seeded permutation from rank to key.

p(rank r) = r^-s / H(n, s) for r in 1..n, exactly, for any s >= 0 (YCSB's
"zipfian" with its default 0.99; the DINOMO paper's 0.5 and 2.0). The CDF
is float64 over all n ranks and a draw is ``searchsorted`` of a uniform
float64. The scramble is ``torch.randperm`` from the run's generator, so
the hot keys lie at places the seed picks, as YCSB's scrambled zipfian
spreads them. Every table and draw is made on the given device from one
``torch.Generator``: the same seed gives the same keys.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    >= 0; reduced into 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def zipf_cdf(n: int, s: float, device) -> torch.Tensor:
    """(n,) float64 CDF of the bounded zipfian over ranks 1..n; the last
    entry is exactly 1."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow_(-s), 0)
    cdf /= cdf[-1].clone()
    cdf[-1] = 1.0
    return cdf


class Zipf:
    """Scrambled bounded zipfian keys over ``[0, n)``."""

    def __init__(self, n: int, s: float, gen: torch.Generator):
        dev = gen.device
        self.n = n
        self.cdf = zipf_cdf(n, s, dev)
        self.scramble = torch.randperm(n, generator=gen, device=dev,
                                       dtype=torch.int64).to(torch.int32)

    def ranks(self, count: int, gen: torch.Generator) -> torch.Tensor:
        """(count,) int64 ranks, 0 the most popular."""
        u = torch.rand(count, dtype=torch.float64, generator=gen,
                       device=self.cdf.device)
        return torch.searchsorted(self.cdf, u).clamp_(max=self.n - 1)

    def keys(self, count: int, gen: torch.Generator) -> torch.Tensor:
        """(count,) int32 keys."""
        return self.scramble[self.ranks(count, gen)]


def exact_probabilities(n: int, s: float) -> torch.Tensor:
    """(n,) float64 p(rank) of the bounded zipfian, rank 0 first."""
    w = torch.arange(1, n + 1, dtype=torch.float64).pow(-s)
    return w / w.sum()
