"""Synthetic LM data pipeline: the port's own copy of the reference's
``data/lm_data.py``, numpy only.

Deterministic, shardable, restart-safe: batch ``i`` is a pure function
of (seed, i), so data-parallel workers slice their shard without
coordination and a restarted job resumes mid-stream from the checkpoint
step counter alone (no data-state checkpoint needed). A background
prefetch thread overlaps host batch synthesis with device compute; it
never touches the card: the training loop uploads each batch in its own
thread.

The token stream is a mixture of Markov chains over the vocab, so the
loss actually *decreases* during training runs (pure iid uniform tokens
would pin the loss at log V). Every batch, token and frame is the
reference's, bit for bit, for the same (seed, step, shard, num_shards).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, num_states: int = 64,
                 encdec_d_model: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.encdec_d_model = encdec_d_model
        rng = np.random.default_rng(seed)
        self.num_states = num_states
        # sparse markov transition structure: each state emits from a
        # small bank of preferred tokens
        self.bank = rng.integers(0, vocab_size, size=(num_states, 32))
        self.next_state = rng.integers(0, num_states,
                                       size=(num_states, 32))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1):
        """Deterministic batch for ``step``; workers pass their shard."""
        if self.global_batch % num_shards:
            raise ValueError(f"batch {self.global_batch} does not split "
                             f"into {num_shards} shards")
        local = self.global_batch // num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        state = rng.integers(0, self.num_states, size=(local,))
        toks = np.empty((local, self.seq_len), np.int32)
        for t in range(self.seq_len):
            choice = rng.integers(0, 32, size=(local,))
            toks[:, t] = self.bank[state, choice]
            state = self.next_state[state, choice]
        out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if self.encdec_d_model:
            out["frames"] = rng.standard_normal(
                (local, self.seq_len, self.encdec_d_model)).astype(
                np.float32) * 0.02
        return out


class Prefetcher:
    """Background-thread prefetch: overlaps host data synthesis with
    device compute. ``next()`` gives (step, batch) in step order from
    ``start_step`` and raises what the source raised; ``close()`` stops
    and joins the thread."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, shard: int = 0, num_shards: int = 1):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._shard = shard
        self._num_shards = num_shards
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.source.batch(step, self._shard,
                                          self._num_shards)
            except Exception as e:      # handed to next(), which raises it
                batch = e
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return
            step += 1

    def next(self):
        step, batch = self.q.get()
        if isinstance(batch, Exception):
            raise batch
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
