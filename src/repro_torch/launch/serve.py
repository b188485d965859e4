"""Paged LLM serving: decode on the DINOMO paged KV store.

Every token's KV is appended to the shared page pool (log-structured
write); decode attention runs per page owner and merges the partials
(ownership partitioning); the prefix cache shares hot prompt pages
(selective replication); and workers can be added or removed mid-flight
with zero page movement, leaving the logits unchanged.

On the card the owners' partials of a layer come from one launch of the
paged_decode_attention kernel over their stacked page tables, which go
to the card in one copy a token. The reference runs one call per owner
and passes ``use_kernel=False`` there (its JAX-on-CPU opt-out); the port
has no such switch: a CUDA pool goes through the kernel, a CPU pool
through its plain version.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 6 --prompt-len 24 --decode-steps 12 --reconfig-at 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_smoke_config
from ..device import resolve_device
from ..kernels.decode_attention.ops import merge_partials
from ..kernels.decode_attention.ref import normalize
from ..kvcache.paged_store import (PagedKVController, decode_over_owners,
                                   owner_partials, pool_append, pool_init,
                                   stack_owners)
from ..kvcache.prefix_cache import PrefixCache
from ..models.layers import qkv_proj, rmsnorm, self_partial, unembed
from ..models.model_zoo import build_model
from ..models.transformer import FAMILIES, feed_forward


class PagedServer:
    """Functional server over the paged pool: OP + DAC + prefix sharing
    on a transformer (dense, MoE or VLM; the MoE feed-forward runs on the
    token alone, as in the reference) with random weights made from
    ``seed``.

    ``cfg`` defaults to the smoke config of ``arch``, as in the
    reference; ``device`` is the card unless ``device="cpu"``. The pool
    is f32, as in the reference."""

    def __init__(self, arch: str = "qwen1.5-0.5b", *, page_size: int = 8,
                 num_pages: int = 4096, workers=("w0", "w1"),
                 seed: int = 0, cfg=None, device=None):
        self.cfg = cfg or get_smoke_config(arch)
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"paged serving takes the attention families "
                             f"{FAMILIES}, not {self.cfg.family!r}")
        self.device = resolve_device(device)
        self.model = build_model(self.cfg)
        self.params = self.model.init(seed, self.device)
        self.pool = pool_init(self.cfg.num_layers, num_pages, page_size,
                              self.cfg.num_kv_heads, self.cfg.hd,
                              torch.float32, self.device)
        self.ctl = PagedKVController(num_pages, page_size, list(workers))
        self.prefix = PrefixCache(self.ctl)
        self.tokens: dict[int, list[int]] = {}
        self._sid = 0
        self.stats = {"tokens": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0}

    # ------------------------------------------------------------------
    def _embed(self, tok: int) -> torch.Tensor:
        return self.params["embed"][torch.tensor([[tok]],
                                                 device=self.device)]

    def _positions(self, pos: int) -> torch.Tensor:
        return torch.full((1, 1), pos, dtype=torch.int32,
                          device=self.device)

    def _head(self, h):
        h = rmsnorm(self.params["ln_f"], h, self.cfg.norm_eps)
        return unembed(self.params, h, self.cfg)[0, 0]

    def _forward_token(self, sid: int, tok: int):
        """One token through the network against the paged pool. Returns
        logits (V,). Appends the token's KV afterwards."""
        cfg = self.cfg
        seq = self.ctl.sequences[sid]
        old_len = seq.length
        pid, off = self.ctl.append_slot(sid)
        stacked = stack_owners(self.ctl.page_tables([sid]), [old_len],
                               self.device) if old_len else None
        positions = self._positions(old_len)
        h = self._embed(tok)
        new_k, new_v = [], []
        for li, lp in enumerate(self.params["layers"]):
            xin = rmsnorm(lp["ln1"], h, cfg.norm_eps)
            q, k, v = qkv_proj(lp["attn"], xin, cfg, positions)
            k0, v0 = k[0, 0], v[0, 0]
            new_k.append(k0)
            new_v.append(v0)
            parts = [self_partial(q[:, 0], k0[None], v0[None])]
            if stacked is not None:
                parts += owner_partials(q[:, 0], self.pool, li, stacked)
            att = normalize(*merge_partials(parts)).to(h.dtype)  # (1, H, D)
            h = h + att.reshape(1, 1, -1) @ lp["attn"]["wo"]
            h = h + feed_forward(lp, h, cfg)[0]
        pool_append(self.pool, pid, off, torch.stack(new_k),
                    torch.stack(new_v))
        self.tokens[sid].append(tok)
        self.stats["tokens"] += 1
        return self._head(h)

    # ------------------------------------------------------------------
    def admit(self, prompt: list[int]):
        """Prefill a request token by token; a shared prefix reuses pooled
        pages. Returns (sid, logits of the last prompt token, or None when
        the whole prompt was a cached prefix)."""
        sid = self._sid
        self._sid += 1
        self.ctl.new_sequence(sid)
        self.tokens[sid] = []
        pages, covered = self.prefix.lookup(prompt)
        if covered:
            self.prefix.attach(sid, pages, covered)
            self.tokens[sid] = list(prompt[:covered])
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += covered
        logits = None
        for tok in prompt[covered:]:
            logits = self._forward_token(sid, tok)
        self.prefix.seal_prefix(sid, prompt)
        return sid, logits

    def decode(self, sid: int, steps: int):
        """``steps`` new tokens, greedy."""
        out = []
        last = self.tokens[sid][-1]
        for _ in range(steps):
            last = int(torch.argmax(self._forward_token(sid, last)))
            out.append(last)
        return out

    def logits_for_next(self, sid: int) -> torch.Tensor:
        """Pure read: the logits of the sequence's last token run again
        against the current pages, without appending (used to show that a
        reconfiguration leaves them unchanged)."""
        cfg = self.cfg
        seq = self.ctl.sequences[sid]
        tables = self.ctl.page_tables([sid])
        positions = self._positions(seq.length)
        h = self._embed(self.tokens[sid][-1])
        for li, lp in enumerate(self.params["layers"]):
            xin = rmsnorm(lp["ln1"], h, cfg.norm_eps)
            q, _, _ = qkv_proj(lp["attn"], xin, cfg, positions)
            att = decode_over_owners(q[:, 0], self.pool, li, tables,
                                     [seq.length])
            h = h + att.reshape(1, 1, -1) @ lp["attn"]["wo"]
            h = h + feed_forward(lp, h, cfg)[0]
        return self._head(h)

    # ------------------------------------------------------------------
    def reconfigure(self, add: str | None = None,
                    remove: str | None = None):
        """Elastic worker change: ring remap only, zero page movement."""
        if add:
            self.ctl.add_worker(add)
        if remove:
            self.ctl.remove_worker(remove)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--decode-steps", type=int, default=12)
    ap.add_argument("--reconfig-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    srv = PagedServer(args.arch, device=args.device)
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, srv.cfg.vocab_size, 16)]
    t0 = time.perf_counter()
    sids = []
    for r in range(args.requests):
        prompt = shared + [int(t) for t in rng.integers(
            0, srv.cfg.vocab_size, args.prompt_len - 16)]
        sid, _ = srv.admit(prompt)
        sids.append(sid)
        if args.reconfig_at is not None and r == args.reconfig_at:
            before = srv.logits_for_next(sids[0])
            srv.reconfigure(add=f"w{2 + r}")
            after = srv.logits_for_next(sids[0])
            torch.testing.assert_close(after, before, atol=1e-4, rtol=1e-4)
            print(f"[serve] reconfig at request {r}: logits unchanged, "
                  f"0 pages moved (workers={srv.ctl.workers})")
    for sid in sids:
        srv.decode(sid, args.decode_steps)
    dt = time.perf_counter() - t0
    st = srv.stats
    print(f"[serve] {st['tokens']} tokens in {dt:.1f}s "
          f"({st['tokens'] / dt:.1f} tok/s host-side), "
          f"prefix hits {st['prefix_hits']} "
          f"(reused {st['prefix_tokens_reused']} tokens), "
          f"local-copy ratio " + ", ".join(
              f"{w}:{srv.ctl.local_copy_ratio(w):.2f}"
              for w in srv.ctl.workers))


if __name__ == "__main__":
    main()
