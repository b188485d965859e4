"""The port's synthetic LM loader (``repro_torch/data/lm_data.py``:
``SyntheticLM``, ``Prefetcher``) against the JAX package's
``repro/data/lm_data.py``: every batch, token and frame bit for bit for
the same (seed, step, shard, num_shards); the prefetcher yields (step,
batch) in order from its start step and joins its thread on close."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM  # noqa: E402


def test_data_determinism_and_shards():
    src = SyntheticLM(512, 32, 8, seed=1)
    a = src.batch(3)
    b = src.batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    s0 = src.batch(3, shard=0, num_shards=4)
    s1 = src.batch(3, shard=1, num_shards=4)
    assert s0["tokens"].shape == (2, 32)
    assert not (s0["tokens"] == s1["tokens"]).all()


@pytest.mark.parametrize("encdec_d_model", [0, 24])
@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 512, 32, 8), (7, 151_936, 64, 4), (123, 1000, 17, 6)])
def test_batches_equal_the_reference_bit_for_bit(seed, vocab, seq, batch,
                                                 encdec_d_model):
    ours = SyntheticLM(vocab, seq, batch, seed=seed,
                       encdec_d_model=encdec_d_model)
    ref = JaxSyntheticLM(vocab, seq, batch, seed=seed,
                         encdec_d_model=encdec_d_model)
    np.testing.assert_array_equal(ours.bank, ref.bank)
    np.testing.assert_array_equal(ours.next_state, ref.next_state)
    for step in (0, 1, 10, 12_345):
        for num_shards in (1, 2):
            for shard in range(num_shards):
                got = ours.batch(step, shard, num_shards)
                want = ref.batch(step, shard, num_shards)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype, k
                    assert got[k].tobytes() == want[k].tobytes(), \
                        (k, step, shard)
    if encdec_d_model:
        assert got["frames"].shape == (batch // 2, seq, encdec_d_model)


def test_shards_must_divide_the_batch():
    with pytest.raises(ValueError, match="shards"):
        SyntheticLM(64, 8, 6, seed=0).batch(0, 0, 4)


def test_prefetcher_yields_steps_in_order_and_joins():
    src = SyntheticLM(256, 16, 4, seed=2)
    pf = Prefetcher(src, start_step=5, depth=2, shard=1, num_shards=2)
    try:
        for want in range(5, 12):
            step, batch = pf.next()
            assert step == want
            ref = src.batch(want, 1, 2)
            for k in ref:
                np.testing.assert_array_equal(batch[k], ref[k])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_what_the_source_raised():
    class Broken(SyntheticLM):
        def batch(self, step, shard=0, num_shards=1):
            if step == 3:
                raise ValueError("bad step 3")
            return super().batch(step, shard, num_shards)

    pf = Prefetcher(Broken(64, 8, 2, seed=0), start_step=2)
    try:
        assert pf.next()[0] == 2
        with pytest.raises(ValueError, match="bad step 3"):
            pf.next()
    finally:
        pf.close()
    assert not pf._thread.is_alive()
