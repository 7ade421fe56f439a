"""Paged KV-cache pool: block arena + per-slot tables + prefix cache.

The port's copy of the JAX package's ``serve/kv_pool.py`` (pure Python, line
for line, so both engines make the same allocations, prefix hits and
evictions on the same trace).

`KVPool` is the host-side allocator behind the paged serve path.  Instead
of one contiguous ``(B, max_len)`` cache region per engine, k/v live in a
flat ``(num_blocks, block_size, Hkv, D)`` arena (device tensors owned by
the ENGINE's slot cache — the pool only does the bookkeeping) and each
batch slot holds a ``(max_blocks,)`` int32 table mapping its logical pages
to arena blocks.  The paged attention kernels (kernels/decode_attention.py,
kernels/prefill_attention.py with ``block_table=``) look pages up in the
table inside the fused launch, so "where slot b's cache lives" becomes
data, not layout — and ``max_len`` stops being a per-engine constant.

Three mechanisms ride on the table indirection:

* **Refcounting + copy-on-write.**  A block may back several slots (shared
  prompt prefix).  Writers call :meth:`prepare_write` first; a block with
  ``ref > 1`` (or one registered in the prefix index, which future slots
  may still match) is replaced by a fresh private copy for that slot and
  the engine copies the arena row.  On the engine path writes only ever
  land on private blocks (admission floors prefix reuse to whole chunks),
  so COW is a guarded invariant rather than a hot path.

* **Prefix cache.**  A radix trie keyed on *full blocks of prompt tokens*
  (node = ``block_size`` consecutive token ids).  :meth:`admit` walks the
  trie along the new prompt; matched nodes' blocks are shared into the
  slot's table (ref++) and those tokens' prefill chunks are SKIPPED
  entirely.  :meth:`register` extends the trie with the slot's own blocks
  once its prompt is fully prefilled, making them matchable by later
  requests.

* **LRU eviction.**  Released blocks that the trie still references stay
  cached (ref 0, evictable) instead of returning to the free list.  When
  :meth:`_alloc` finds the free list empty it evicts the least-recently-
  used ref-0 trie LEAF (children pin parents, so the trie never dangles);
  admission degrades gracefully instead of rejecting.

Blocks ``0..slots-1`` are per-slot *sentinels*: slot ``b``'s table rows
point at sentinel ``b`` until a real block is mapped, so the vectorized
decode scatter (which writes through ``table[b, pos[b] // bs]`` for every
slot, active or not) can never land an inactive slot's stale write on a
block another slot owns.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from math import gcd
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class _TrieNode:
    """One full block of prompt tokens in the prefix index."""
    key: Tuple[int, ...]                      # block_size token ids
    block: int                                # arena block holding their k/v
    parent: Optional["_TrieNode"]
    children: Dict[Tuple[int, ...], "_TrieNode"] = field(default_factory=dict)
    last_use: int = 0


class KVPool:
    """Bookkeeping for a paged KV arena shared by ``slots`` batch slots.

    Pure host-side Python: the engine reads :attr:`table` into a
    device tensor each step and performs the actual arena row copies /
    scatters itself.  ``now`` arguments are the engine's monotonic step
    counter, used for LRU ordering.
    """

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 max_blocks_per_slot: int):
        if num_blocks < slots + 1:
            raise ValueError(
                f"num_blocks={num_blocks} must exceed slots={slots} "
                "(one sentinel per slot + at least one usable block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_blocks_per_slot = max_blocks_per_slot
        # blocks 0..slots-1 are sentinels, never allocated or shared
        self.free: deque[int] = deque(range(slots, num_blocks))
        self.ref: List[int] = [0] * num_blocks
        self.table: List[List[int]] = [
            [b] * max_blocks_per_slot for b in range(slots)]
        self.owned: List[int] = [0] * slots   # mapped real blocks per slot
        self._root = _TrieNode(key=(), block=-1, parent=None)
        self._node_of: Dict[int, _TrieNode] = {}   # arena block -> trie node
        self.evictions = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0

    # ------------------------------------------------------------------
    # Allocation / eviction
    # ------------------------------------------------------------------
    @property
    def blocks_in_use(self) -> int:
        """Real (non-sentinel) blocks not on the free list — includes ref-0
        blocks parked in the prefix cache."""
        return self.num_blocks - self.slots - len(self.free)

    def _alloc(self, now: int) -> Optional[int]:
        if self.free:
            return self.free.popleft()
        victim = self._lru_evictable()
        if victim is None:
            return None
        self._evict(victim)
        return self.free.popleft()

    def _lru_evictable(self) -> Optional[_TrieNode]:
        best = None
        for node in self._node_of.values():
            if node.children or self.ref[node.block] != 0:
                continue                       # interior or still shared
            if best is None or node.last_use < best.last_use:
                best = node
        return best

    def _evict(self, node: _TrieNode) -> None:
        assert not node.children and self.ref[node.block] == 0
        node.parent.children.pop(node.key, None)
        del self._node_of[node.block]
        self.free.append(node.block)
        self.evictions += 1

    # ------------------------------------------------------------------
    # Slot lifecycle
    # ------------------------------------------------------------------
    def admit(self, slot: int, tokens: Sequence[int], chunk: int,
              now: int) -> int:
        """Claim ``slot`` for a prompt.  Walks the prefix trie along
        ``tokens`` (full-block granularity), shares every matched block
        into the slot's table, and returns ``reuse``: the number of prompt
        tokens whose prefill is skipped.  ``reuse`` is floored to a
        multiple of ``chunk`` (the engine's effective chunk rows) so every
        later chunk offset stays chunk-aligned, and capped at
        ``len(tokens) - 1`` so the final chunk — the one whose last row
        yields the first sampled token — always runs."""
        bs = self.block_size
        row = self.table[slot]
        assert self.owned[slot] == 0, f"slot {slot} not released"
        matched: List[int] = []
        node = self._root
        for i in range(min(len(tokens) // bs, self.max_blocks_per_slot)):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            matched.append(child.block)
            node = child
        # floor to a multiple of both the chunk (keeps every later chunk
        # offset aligned) and the block size (shares only whole blocks)
        chunk = max(chunk, 1)
        align = bs * chunk // gcd(bs, chunk)
        reuse = min(len(matched) * bs, len(tokens) - 1)
        reuse -= reuse % align
        nblk = reuse // bs
        for i in range(nblk):
            self.ref[matched[i]] += 1
            row[i] = matched[i]
        self.owned[slot] = nblk
        if reuse:
            self.prefix_hits += 1
            self.prefix_tokens_reused += reuse
        return reuse

    def ensure_rows(self, slot: int, start: int, end: int,
                    now: int) -> bool:
        """Map fresh private blocks for logical token rows [start, end).
        Returns False (partial mappings kept) when the arena is exhausted
        even after eviction — the engine stalls that chunk / retires that
        slot instead of crashing."""
        bs = self.block_size
        row = self.table[slot]
        first = start // bs
        last = (max(end, start + 1) - 1) // bs
        if last >= self.max_blocks_per_slot:
            return False
        for i in range(first, last + 1):
            if i < self.owned[slot]:
                continue                       # already mapped (or shared)
            blk = self._alloc(now)
            if blk is None:
                return False
            self.ref[blk] += 1
            row[i] = blk
            self.owned[slot] = i + 1
        return True

    def prepare_write(self, slot: int, logical: int,
                      now: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard before the engine writes token row
        ``logical`` of ``slot``.  If the backing block is shared
        (``ref > 1``) or registered in the prefix index, map a fresh
        private block and return ``(new, old)`` so the engine copies the
        arena row; returns None when the block is already private."""
        i = logical // self.block_size
        row = self.table[slot]
        blk = row[i]
        if blk < self.slots:
            return None                        # sentinel: nothing mapped yet
        if self.ref[blk] == 1 and blk not in self._node_of:
            return None
        new = self._alloc(now)
        if new is None:
            raise RuntimeError("KVPool exhausted during copy-on-write")
        self.ref[blk] -= 1
        self.ref[new] += 1
        row[i] = new
        self.cow_copies += 1
        return new, blk

    def register(self, slot: int, tokens: Sequence[int], now: int) -> None:
        """Extend the prefix trie with ``slot``'s blocks for every FULL
        block of ``tokens`` (called once the prompt is entirely in cache).
        Blocks already indexed (shared via a prefix hit) are skipped; a
        block can back at most one trie node."""
        bs = self.block_size
        row = self.table[slot]
        node = self._root
        for i in range(min(len(tokens) // bs, self.owned[slot])):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                blk = row[i]
                if blk in self._node_of:
                    break                      # block already indexes another path
                child = _TrieNode(key=key, block=blk, parent=node,
                                  last_use=now)
                node.children[key] = child
                self._node_of[blk] = child
            child.last_use = now
            node = child

    def release(self, slot: int) -> None:
        """Retire ``slot``: down-ref every mapped block and reset the table
        row to the slot's sentinel.  Ref-0 blocks return to the free list
        unless the prefix trie still indexes them — those stay cached
        (evictable) so the next matching prompt skips their prefill."""
        row = self.table[slot]
        for i in range(self.owned[slot]):
            blk = row[i]
            self.ref[blk] -= 1
            if self.ref[blk] == 0 and blk not in self._node_of:
                self.free.append(blk)
            row[i] = slot
        self.owned[slot] = 0

    # ------------------------------------------------------------------
    # Introspection (the serve launcher's --kv-snapshot)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        cached = sum(1 for b, n in self._node_of.items()
                     if self.ref[b] == 0 and not n.children)
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "slots": self.slots,
            "max_blocks_per_slot": self.max_blocks_per_slot,
            "blocks_in_use": self.blocks_in_use,
            "free_blocks": len(self.free),
            "evictable_blocks": cached,
            "evictions": self.evictions,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "cow_copies": self.cow_copies,
            "trie_nodes": len(self._node_of),
            "tables": [
                {"slot": b, "owned": self.owned[b],
                 "blocks": list(self.table[b][:self.owned[b]])}
                for b in range(self.slots)],
        }
