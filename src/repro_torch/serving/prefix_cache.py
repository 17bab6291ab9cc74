"""Shared-prefix KV index: refcounted page sharing for group rollouts.

The port's own copy of ``repro.serving.prefix_cache`` (pure Python and
numpy; no framework code).

The third layer of the serving cache stack (slots -> pages -> *shared*
pages).  DiPO's online loop rolls out ``group_size`` G trajectories per
prompt, so a paged pool without sharing prefills the identical prompt G
times and holds G copies of the same KV pages.  This module is the
vLLM/SGLang-style fix: a block-granular radix index over *committed
prompt blocks*, mapping block content to the page that already holds its
keys, with per-page reference counts layered onto the scheduler's
free-list allocator.

Key structure
-------------
A prompt is identified block-by-block with a *chained* content hash:
``key[b] = H(key[b-1] ++ tokens of block b)``.  A key therefore commits
to the entire absolute prefix ``blocks [0, b]`` — equal keys imply equal
tokens at equal positions, which is exactly the condition under which
one KV page can serve many sequences (pages store rotated keys with
absolute position ids).  The chain makes the flat ``dict`` a radix trie:
looking up a prompt walks its chain keys in order and stops at the first
absent entry, yielding the longest cached prefix.

Lifecycle
---------
* **register** — at admission, each freshly prefilled *prompt* block is
  inserted with ``refs=1``.  Generated blocks are never registered:
  shared pages are read-only prompt blocks by construction (a live
  slot's commit cursor never re-enters its prompt region), so no
  copy-on-write machinery is needed.
* **acquire** — a later request whose prefix matches bumps the refcount
  of every hit entry and maps the hit pages straight into its block
  table; only the suffix is prefilled.
* **release** — slot eviction decrements.  At ``refs == 0`` the entry
  stays *cached* (the page keeps its contents and is not returned to
  the free list) so future groups can still hit it.
* **evict_lru** — under page pressure the allocator reclaims idle
  (``refs == 0``) entries leaf-first in LRU order.  Entries with live
  references are never evicted, so reservation-based admission keeps
  its no-deadlock guarantee: every page is either free, reclaimable, or
  covered by a live slot's reservation/refcount.

Leaf-first eviction keeps the trie sound: an interior entry is only
reclaimed once no longer-prefix entry depends on it, so a lookup can
never match a chain with a hole.  Idle subtrees always contain an idle
leaf (a live reference on a descendant implies live references on every
ancestor, because hits are taken as contiguous chains from the root),
so the number of reclaimable pages always equals the number of idle
entries.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


def chain_keys(prompt: np.ndarray, block_size: int) -> list[bytes]:
    """Chained per-block content keys for a block-aligned prompt.

    ``key[b]`` hashes the previous key plus block ``b``'s tokens, so it
    commits to the whole prefix ``[0, b]`` *at its absolute positions* —
    the invariant that makes a KV page (rotated keys + position ids)
    reusable verbatim by any prompt sharing that prefix.
    """
    arr = np.ascontiguousarray(np.asarray(prompt, np.int32))
    assert arr.ndim == 1 and arr.shape[0] % block_size == 0
    keys: list[bytes] = []
    prev = b""
    for b in range(arr.shape[0] // block_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(arr[b * block_size:(b + 1) * block_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


@dataclasses.dataclass
class Entry:
    """One cached prompt block: its chain key, the page holding its KV,
    the number of live slots referencing it, and trie/LRU bookkeeping."""
    key: bytes
    parent: bytes | None
    page: int
    refs: int = 0
    children: int = 0
    stamp: int = 0


class PrefixIndex:
    """Radix index of committed prompt blocks -> page ids.

    Pure host-side bookkeeping: pages themselves live in the scheduler's
    ``PagedAttnCache`` pools; this class only decides which page ids are
    shared, which are idle-but-cached, and which may be reclaimed.
    """

    def __init__(self) -> None:
        self._entries: dict[bytes, Entry] = {}
        self._clock = 0
        self.n_active = 0        # entries with refs >= 1
        self.n_shared = 0        # entries with refs >= 2

    # ------------------------------------------------------------ views
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    @property
    def n_idle(self) -> int:
        """Cached entries with no live reference (reclaimable)."""
        return len(self._entries) - self.n_active

    def entry(self, key: bytes) -> Entry:
        return self._entries[key]

    # ---------------------------------------------------------- lookup
    def match(self, keys: list[bytes]) -> list[Entry]:
        """Longest cached prefix: entries for ``keys[:h]``, h maximal."""
        out: list[Entry] = []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            out.append(e)
        return out

    # -------------------------------------------------------- refcounts
    def acquire(self, entries: list[Entry]) -> None:
        """Take one live reference on each hit entry (and touch LRU).

        Must be called *before* any page allocation for the same
        admission: an un-acquired hit with ``refs == 0`` is reclaimable
        and could be evicted out from under the request.
        """
        self._clock += 1
        for e in entries:
            if e.refs == 0:
                self.n_active += 1
            elif e.refs == 1:
                self.n_shared += 1
            e.refs += 1
            e.stamp = self._clock

    def register(self, keys: list[bytes], start: int,
                 pages: list[int]) -> list[bytes]:
        """Insert freshly prefilled prompt blocks ``keys[start:]``.

        ``pages[i]`` holds block ``start + i``'s committed KV.  New
        entries are born with ``refs = 1`` (the admitting slot).  The
        parent of ``keys[start]`` must already be present — i.e.
        ``start`` is the match length returned by :meth:`match` for the
        same admission.  Returns the keys the slot now holds references
        on (caller passes hit keys + these to :meth:`release` later).
        """
        assert len(pages) == len(keys) - start
        self._clock += 1
        parent = keys[start - 1] if start > 0 else None
        new: list[bytes] = []
        for k, page in zip(keys[start:], pages):
            assert k not in self._entries, "duplicate prefix registration"
            self._entries[k] = Entry(key=k, parent=parent, page=int(page),
                                     refs=1, stamp=self._clock)
            self.n_active += 1
            if parent is not None:
                self._entries[parent].children += 1
            parent = k
            new.append(k)
        return new

    def release(self, keys: list[bytes]) -> None:
        """Drop one live reference per key (slot eviction).

        Entries reaching ``refs == 0`` stay cached — their pages are
        reclaimed lazily by :meth:`evict_lru` under page pressure.
        """
        for k in keys:
            e = self._entries[k]
            assert e.refs > 0, "refcount underflow"
            e.refs -= 1
            if e.refs == 0:
                self.n_active -= 1
            elif e.refs == 1:
                self.n_shared -= 1

    # ---------------------------------------------------------- reclaim
    def evict_lru(self) -> int | None:
        """Reclaim the LRU idle *leaf* entry; returns its page id.

        Never touches an entry with live references, and never leaves a
        dangling child (leaf-first), so the index stays a sound trie.
        Returns None when nothing is reclaimable.  Linear scan per
        reclaim — reclaims happen only under page pressure and the index
        is bounded by the page pool; an idle-leaf heap would make this
        O(log n) if pools grow by orders of magnitude.
        """
        best: Entry | None = None
        for e in self._entries.values():
            if e.refs == 0 and e.children == 0 and \
                    (best is None or e.stamp < best.stamp):
                best = e
        if best is None:
            return None
        del self._entries[best.key]
        if best.parent is not None and best.parent in self._entries:
            self._entries[best.parent].children -= 1
        return best.page
