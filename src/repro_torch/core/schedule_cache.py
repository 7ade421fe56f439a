"""Persistent schedule cache — never re-search a bundle already tuned.

The port's own copy of the reference's ``src/repro/core/schedule_cache.py``:
entries keyed by an exact *bundle signature* (op names, grids, operand
shapes/dtypes/block shapes, FLOP/byte counts, the working-set budget, the
scoring mode and, for a plan of one tensor-parallel shard, the mesh tag),
an LRU side table (``meta``/``clock``)
bounded by ``max_entries``, ``batched()`` to defer disk writes over a whole
plan, a merge of concurrent writers on save, and a corrupt or stale file
read as an empty cache.

It keeps its own ``CACHE_VERSION``, default path
(``build/repro_torch/schedule_cache.json`` at the root of the checkout,
beside the kernel builds) and environment variables
(``$REPRO_TORCH_SCHEDULE_CACHE``, ``$REPRO_TORCH_SCHEDULE_CACHE_MAX``), so
it never reads or writes the reference's cache file: a "gpu" entry holds
card times, and the port's members launch another CTA geometry.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.core.op_spec import OpSpec

CACHE_VERSION = 1

_DTYPE_NAMES = {"torch.bfloat16": "bfloat16", "torch.float32": "float32",
                "torch.float16": "float16", "torch.int32": "int32"}


def _dtype_name(dtype) -> str:
    return _DTYPE_NAMES.get(str(dtype), str(dtype))


def bundle_signature(ops: Sequence[OpSpec], *, vmem_budget: int,
                     mode: str = "costmodel", mesh_tag: str = "") -> str:
    """Exact identity of a tuning problem: everything the search outcome
    can depend on, nothing it cannot (the plain functions, the members).

    ``mesh_tag`` names the mesh a sharded plan tunes one shard for
    (``"model:4"``: the axis and its extent).  Shard-local shapes alone
    can equal an unsharded graph's (8 heads on 2 shards, 4 heads on one),
    so the tag is part of the identity."""
    parts = [f"torch-v{CACHE_VERSION}", mode, str(int(vmem_budget))]
    if mesh_tag:
        parts.append(f"mesh[{mesh_tag}]")
    for op in ops:
        operands = ",".join(
            "{}:{}:{}".format("x".join(map(str, o.shape)),
                              _dtype_name(o.dtype),
                              "x".join(map(str, o.block_shape)))
            for o in (*op.inputs, *op.outputs))
        # a stitched chain tunes differently from the unstitched op set
        chain = f"|c[{'>'.join(op.chain)}]+{int(op.extra_vmem_bytes)}" \
            if op.chain else ""
        parts.append(f"{op.name}|g{op.grid}|f{op.flops:.6g}"
                     f"|h{op.hbm_bytes:.6g}|{operands}{chain}")
    return hashlib.sha256(";".join(parts).encode()).hexdigest()[:32]


class ScheduleCache:
    """In-memory dict with optional JSON persistence, an LRU size bound
    and per-entry usage metadata (kept in a side table, so
    entry dicts stay exactly what callers stored)."""

    def __init__(self, path: Optional[os.PathLike | str] = None,
                 max_entries: Optional[int] = None):
        self.path = Path(path) if path else None
        self.max_entries = max_entries
        self.entries: dict[str, dict] = {}
        self.meta: dict[str, dict] = {}       # key -> {last_used, uses}
        self.clock = 0
        self.evictions = 0
        self._defer = False
        self._dirty = False
        if self.path is not None:
            self.load()

    # ------------------------------------------------------------------
    def _touch(self, key: str, used: bool) -> None:
        self.clock += 1
        m = self.meta.setdefault(key, {"last_used": 0, "uses": 0})
        m["last_used"] = self.clock
        if used:
            m["uses"] = m.get("uses", 0) + 1
            if self._defer:
                self._dirty = True

    def get(self, key: str) -> Optional[dict]:
        entry = self.entries.get(key)
        if entry is not None:
            self._touch(key, used=True)
        return entry

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry
        self._touch(key, used=False)
        if self.max_entries is not None:
            while len(self.entries) > self.max_entries:
                victim = min(
                    (k for k in self.entries if k != key),
                    key=lambda k: self.meta.get(k, {}).get("last_used", 0))
                del self.entries[victim]
                self.meta.pop(victim, None)
                self.evictions += 1
        if self._defer:
            self._dirty = True
        elif self.path is not None:
            self.save()

    @contextlib.contextmanager
    def batched(self):
        """Defer disk writes until the block exits: one save for a whole
        plan instead of a rewrite per put()."""
        prev = self._defer
        self._defer = True
        try:
            yield self
        finally:
            self._defer = prev
            if self._dirty and not self._defer:
                self._dirty = False
                self.save()

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------------
    def load(self) -> None:
        if self.path is None or not self.path.exists():
            return
        try:
            blob = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            return                            # corrupt cache == empty cache
        if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
            return                            # stale schema: discard
        self.entries.update(blob.get("entries", {}))
        self.meta.update(blob.get("meta", {}))
        self.clock = max(self.clock, int(blob.get("clock", 0)))

    def save(self) -> None:
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # merge concurrent writers: keys are content-addressed, so entries
        # another process added since our load are kept (ours win on clash)
        merged = dict(self.entries)
        merged_meta = dict(self.meta)
        clock = self.clock
        try:
            blob = json.loads(self.path.read_text())
            if isinstance(blob, dict) and blob.get("version") == CACHE_VERSION:
                merged = {**blob.get("entries", {}), **self.entries}
                merged_meta = {**blob.get("meta", {}), **self.meta}
                clock = max(clock, int(blob.get("clock", 0)))
        except (FileNotFoundError, json.JSONDecodeError, OSError,
                UnicodeDecodeError):
            pass
        merged_meta = {k: m for k, m in merged_meta.items() if k in merged}
        if self.max_entries is not None:          # the bound survives the
            while len(merged) > self.max_entries:  # merge: evicted stay out
                victim = min(merged, key=lambda k: merged_meta.get(k, {})
                             .get("last_used", 0))
                del merged[victim]
                merged_meta.pop(victim, None)
        tmp = self.path.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(
            {"version": CACHE_VERSION, "entries": merged,
             "meta": merged_meta, "clock": clock},
            indent=1, sort_keys=True))
        tmp.replace(self.path)                # atomic on POSIX
        self.entries = merged
        self.meta = merged_meta
        self.clock = clock


DEFAULT_PATH = (Path(__file__).resolve().parents[3] / "build" / "repro_torch"
                / "schedule_cache.json")


def default_cache() -> ScheduleCache:
    """A cache at ``$REPRO_TORCH_SCHEDULE_CACHE`` (default
    ``DEFAULT_PATH``), bounded by ``$REPRO_TORCH_SCHEDULE_CACHE_MAX``
    entries (LRU, default 512)."""
    path = os.environ.get("REPRO_TORCH_SCHEDULE_CACHE", str(DEFAULT_PATH))
    bound = int(os.environ.get("REPRO_TORCH_SCHEDULE_CACHE_MAX", "512"))
    return ScheduleCache(path, max_entries=bound or None)
