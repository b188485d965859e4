"""Log-structured elastic checkpointing (DINOMO T4 applied to training):
the port's copy of the reference's ``checkpoint/ckpt.py``, on torch
tensors, writing the reference's files and manifests byte for byte.

Checkpoints are written the way DINOMO writes data:
  * every leaf tensor is appended as a *sealed segment* (write to a temp
    file, flush and fsync, CRC32, atomic rename == commit marker);
  * a manifest (the 'metadata index') is merged *after* all segments are
    durable, itself sealed by atomic rename; a crash between the two
    leaves a consistent older checkpoint (un-merged segments are simply
    garbage-collected, exactly like torn log entries);
  * flushing is asynchronous (a two-worker pool) so the train loop does
    not block -- the DPM-processor async-merge analogy. ``save`` copies
    every leaf to the host before it returns: the train step updates the
    parameters and the optimizer state in place, and a flush that read
    the card's tensors would write a mix of two steps;
  * a restore puts the same bytes on the device it is given (ownership
    re-mapped, nothing on disk moves).

Layout (the reference's):
  <dir>/segments/<step>/<leaf>.npy
  <dir>/MANIFEST-<step>.json            (sealed by rename)

A tree is nested dicts, lists and tuples; its leaves are torch tensors
(on any device) or what ``np.asarray`` takes. Leaves are named as JAX's
``tree_flatten_with_path`` names them (dict keys in sorted order), so a
tree the reference saves restores here and the reverse. bf16 and float8
are stored as their raw uint16 / uint8 bits with the logical dtype in the
manifest, as the reference stores them.

``stats`` holds the seconds of each stage (the host copy, the segments'
writes, fsyncs and CRCs, the manifests, the validations, the loads and
the uploads), the bytes written and read, and the CRC passes.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device

# numpy can't natively hold bf16/fp8: store such tensors as raw uint
# views and restore the logical dtype from metadata. Each entry: the
# logical torch dtype, the torch dtype of its bits and the numpy dtype
# of the same bits (torch has no uint16), and the stored numpy dtype
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_LOGICAL = {v[0]: k for k, v in _EXOTIC.items()}
STAT_KEYS = ("copy_s", "write_s", "fsync_s", "crc_s", "manifest_s",
             "gc_s", "validate_s", "load_s", "upload_s", "bytes_written",
             "bytes_read", "crc_passes", "crc_bytes")


def _to_storage(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` that no later in-place write reaches, its
    logical dtype): bf16 and float8 as their bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _LOGICAL:
            name = _LOGICAL[t.dtype]
            _, bits, _, stored = _EXOTIC[name]
            return t.view(bits).numpy().view(stored), name
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_storage(arr: np.ndarray, dtype: str, dev) -> torch.Tensor:
    if dtype in _EXOTIC:
        logical, _, np_bits, _ = _EXOTIC[dtype]
        return torch.from_numpy(arr.view(np_bits)).to(dev).view(logical)
    return torch.from_numpy(arr).to(dev)


def _key_name(key) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "", str(key))


def _flatten(tree, path=()):
    """(path, leaf) in JAX's flatten order: dict keys sorted, sequences by
    index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _leaf_paths(tree):
    """[(name, leaf)]: the reference's ``_leaf_paths`` of the same tree."""
    return [("/".join(_key_name(p) for p in path) or "root", leaf)
            for path, leaf in _flatten(tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in flatten order from
    the iterator ``leaves``."""
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _crc(path: str) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read()) & 0xFFFFFFFF


class CheckpointStore:
    def __init__(self, directory: str, async_flush: bool = True,
                 keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(os.path.join(directory, "segments"), exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=2) if async_flush \
            else None
        self._pending: list[Future] = []
        self._lock = threading.Lock()
        self.stats = dict.fromkeys(STAT_KEYS, 0)

    def _add(self, **delta) -> None:
        with self._lock:
            for k, v in delta.items():
                self.stats[k] += v

    # ------------------------------------------------------------------
    def _write_segment(self, step: int, name: str, host):
        seg_dir = os.path.join(self.dir, "segments", str(step))
        os.makedirs(seg_dir, exist_ok=True)
        fname = name.replace("/", "__") + ".npy"
        tmp = os.path.join(seg_dir, "." + fname + ".tmp")
        final = os.path.join(seg_dir, fname)
        stored, logical = host
        t0 = time.perf_counter()
        with open(tmp, "wb") as f:
            np.save(f, stored)
            f.flush()
            t1 = time.perf_counter()
            os.fsync(f.fileno())
            size = f.tell()
        t2 = time.perf_counter()
        crc = _crc(tmp)
        t3 = time.perf_counter()
        os.replace(tmp, final)                      # seal (commit marker)
        self._add(write_s=t1 - t0, fsync_s=t2 - t1, crc_s=t3 - t2,
                  bytes_written=size, crc_passes=1, crc_bytes=size)
        return fname, crc, stored.shape, logical

    def save(self, step: int, tree, extra: dict | None = None) -> Future:
        """Persist ``tree`` asynchronously; returns a Future that resolves
        when the manifest is sealed. Every leaf is copied to the host
        before this returns."""
        t0 = time.perf_counter()
        leaves = [(name, _to_storage(leaf))
                  for name, leaf in _leaf_paths(tree)]
        self._add(copy_s=time.perf_counter() - t0)

        def flush():
            entries = {}
            for name, host in leaves:
                fname, crc, shape, dtype = self._write_segment(step, name,
                                                               host)
                entries[name] = {"file": fname, "crc": crc,
                                 "shape": list(shape), "dtype": dtype}
            t1 = time.perf_counter()
            manifest = {"step": step, "entries": entries,
                        "extra": extra or {}, "sealed": True}
            tmp = os.path.join(self.dir, f".MANIFEST-{step}.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, f"MANIFEST-{step}.json"))
            t2 = time.perf_counter()
            self._gc()
            self._add(manifest_s=t2 - t1, gc_s=time.perf_counter() - t2)
            return step

        if self._pool is None:
            fut: Future = Future()
            fut.set_result(flush())
            return fut
        fut = self._pool.submit(flush)
        with self._lock:
            self._pending.append(fut)
        return fut

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = re.match(r"MANIFEST-(\d+)\.json$", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _valid(self, step: int) -> dict | None:
        """The manifest of ``step`` if it is sealed and every segment it
        names exists with its CRC; else None (a torn or corrupt
        checkpoint)."""
        t0 = time.perf_counter()
        try:
            return self._check(step)
        finally:
            self._add(validate_s=time.perf_counter() - t0)

    def _check(self, step: int) -> dict | None:
        path = os.path.join(self.dir, f"MANIFEST-{step}.json")
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(manifest, dict) or not manifest.get("sealed"):
            return None
        seg_dir = os.path.join(self.dir, "segments", str(step))
        for ent in manifest["entries"].values():
            f = os.path.join(seg_dir, ent["file"])
            if not os.path.exists(f):
                return None
            t0 = time.perf_counter()
            crc = _crc(f)
            self._add(crc_s=time.perf_counter() - t0, crc_passes=1,
                      crc_bytes=os.path.getsize(f))
            if crc != ent["crc"]:
                return None                       # torn/corrupt segment
        return manifest

    def latest_valid(self) -> int | None:
        for step in reversed(self.steps()):
            if self._valid(step) is not None:
                return step
        return None

    def restore(self, template, step: int | None = None, device=None):
        """Restore into the structure of ``template`` (its leaves are not
        read), every leaf a tensor on ``device`` (the card unless
        ``"cpu"``): the same bytes, re-owned by whichever device loads
        them. Returns (tree, extra, step); the latest valid step when
        ``step`` is None."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_valid()
            if step is None:
                raise FileNotFoundError("no valid checkpoint")
        manifest = self._valid(step)
        if manifest is None:
            raise IOError(f"checkpoint {step} failed validation")
        seg_dir = os.path.join(self.dir, "segments", str(step))
        arrays = []
        for name, _ in _leaf_paths(template):
            ent = manifest["entries"][name]
            t0 = time.perf_counter()
            arr = np.load(os.path.join(seg_dir, ent["file"]))
            t1 = time.perf_counter()
            arrays.append(_from_storage(arr, ent["dtype"], dev))
            self._add(load_s=t1 - t0, upload_s=time.perf_counter() - t1,
                      bytes_read=arr.nbytes)
        if dev.type == "cuda":
            t0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            self._add(upload_s=time.perf_counter() - t0)
        return _unflatten(template, iter(arrays)), manifest["extra"], step

    def _gc(self):
        steps = self.steps()
        valid = [s for s in steps if self._valid(s) is not None]
        for s in valid[:-self.keep] if self.keep else []:
            try:
                os.remove(os.path.join(self.dir, f"MANIFEST-{s}.json"))
                seg = os.path.join(self.dir, "segments", str(s))
                for f in os.listdir(seg):
                    os.remove(os.path.join(seg, f))
                os.rmdir(seg)
            except OSError:
                pass
