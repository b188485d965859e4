"""The flash-attention wrapper's block-shape choice, a plain function of
Sq and the head dim that the CPU can check: the bf16 kernel runs 3
consumer warpgroups (192 query rows a block) at head dims up to 64,
unless 192-row blocks pad Sq by more than 1/16 beyond 128-row blocks,
and 2 (128 rows) otherwise. Exact integers, no tolerance."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tf  # noqa: E402


@pytest.mark.parametrize("sq,d,want", [
    (2048, 64, 3),     # qwen1.5-0.5b and zamba2-1.2b prefill: 2,112 rows
    (32768, 64, 3),    # the long prefill
    (4096, 64, 3),     # the long train step
    (1500, 64, 3),     # seamless-m4t-medium's encoder: 1,536 rows either way
    (256, 64, 2),      # its decoder over the memory: 384 rows against 256
    (1, 64, 2),
    (100, 32, 2),
    (300, 16, 3),      # 384 rows either way
    (2048, 128, 2),    # three consumers do not fit at D = 128
    (32768, 128, 2),
])
def test_consumer_warpgroups_at_the_main_paths_views(sq, d, want):
    assert tf.consumer_warpgroups(sq, d) == want


@pytest.mark.parametrize("d", tf.HEAD_DIMS)
def test_consumer_warpgroups_bounds_the_padding(d):
    """Over every Sq up to 40,000: the answer is 2 or 3, 3 only at d <= 64,
    and the rows the chosen blocks cover are at most 17/16 of what 128-row
    blocks cover."""
    for sq in range(1, 40001):
        c = tf.consumer_warpgroups(sq, d)
        assert c in (2, 3)
        assert c == 2 or d <= 64
        rows = -(-sq // (64 * c)) * 64 * c
        assert 16 * rows <= 17 * (-(-sq // 128) * 128), (sq, d, c)
