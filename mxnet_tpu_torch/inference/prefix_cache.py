"""Radix tree over token-id prefixes -> cached KV page runs.

The port's own copy of ``mxnet_tpu/inference/prefix_cache.py`` (pure
Python; the port imports nothing of the JAX package): the host-side index
behind prefix-sharing serving. One tree node = one FULL page: the edge
key is the exact tuple of ``page_size`` token ids that page covers, so
walking the tree with a prompt yields the longest run of already-computed
pages whose token content matches the prompt's head byte-for-byte. The
tree stores page *ids* only — refcounts and pool bytes belong to the
engine's allocator; the cache holds one reference on every page it
indexes (the engine bumps/releases refcounts around :meth:`insert` /
:meth:`evict`).

Design points:

  - **Full pages only.** A partially filled tail page is never indexed:
    its unwritten positions would go stale the moment the donor row kept
    decoding. The engine adopts a cached page covering a prompt's partial
    tail by copy-on-write instead.
  - **LRU leaf eviction.** Under free-page pressure the engine evicts
    least-recently-walked leaves, and only pages the predicate allows —
    eviction refuses pages with refcount > 1 (still shared with a live
    row), so a hit can never yank pages out from under a decode.
  - **No per-token trie.** Keys are whole-page token tuples (hashed by
    dict), so a walk costs O(prefix_pages) regardless of page size.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["RadixPrefixCache"]


class _Node:
    __slots__ = ("children", "parent", "edge", "page", "stamp")

    def __init__(self, parent: Optional["_Node"], edge: Optional[tuple],
                 page: Optional[int]):
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.edge = edge
        self.page = page
        self.stamp = 0


class RadixPrefixCache:
    """Token-prefix -> page-run index with LRU leaf eviction."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self._root = _Node(None, None, None)
        self._clock = 0  # LRU: monotonically increasing walk counter
        self._count = 0  # indexed pages (== non-root nodes)

    def __len__(self) -> int:
        return self._count

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _edges(self, tokens: Sequence[int]) -> List[tuple]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n_full)]

    # -- walk / insert -------------------------------------------------------
    def lookup(self, tokens: Sequence[int],
               touch: bool = True) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: ``(page_ids,
        matched_tokens)`` where ``matched_tokens`` is always a multiple of
        ``page_size``. ``touch=False`` probes without advancing the LRU
        clock (admission sizing should not look like traffic)."""
        node, pages = self._root, []
        stamp = self._tick() if touch else None
        for edge in self._edges(tokens):
            child = node.children.get(edge)
            if child is None:
                break
            if stamp is not None:
                child.stamp = stamp
            pages.append(child.page)
            node = child
        return pages, len(pages) * self.page_size

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> List[int]:
        """Index the full pages of a computed sequence. ``pages`` is the
        owning row's page run (``pages[i]`` covers tokens ``i*ps ..
        (i+1)*ps - 1``). Already-indexed prefixes are kept (first writer
        wins — the existing cached page is as good as the duplicate).
        Returns the page ids newly referenced by the cache; the caller
        owns bumping their refcounts."""
        node, new_refs = self._root, []
        stamp = self._tick()
        edges = self._edges(tokens)
        for i, edge in enumerate(edges):
            if i >= len(pages):
                break
            child = node.children.get(edge)
            if child is None:
                child = _Node(node, edge, int(pages[i]))
                node.children[edge] = child
                self._count += 1
                new_refs.append(child.page)
            child.stamp = stamp
            node = child
        return new_refs

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> Iterator[_Node]:
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and not node.children:
                yield node
            stack.extend(node.children.values())

    def evict(self, n: int, evictable: Callable[[int], bool],
              protect: Sequence[int] = ()) -> List[int]:
        """Drop up to ``n`` least-recently-walked leaf pages for which
        ``evictable(page_id)`` holds (the engine passes ``refcount == 1``:
        cache-only pages). Evicting a leaf may expose its parent as the
        next candidate. Returns the evicted page ids (the caller releases
        their refcounts)."""
        guard = set(int(p) for p in protect)
        out: List[int] = []
        while len(out) < n:
            victim = None
            for leaf in self._leaves():
                if leaf.page in guard or not evictable(leaf.page):
                    continue
                if victim is None or leaf.stamp < victim.stamp:
                    victim = leaf
            if victim is None:
                break
            del victim.parent.children[victim.edge]
            self._count -= 1
            out.append(victim.page)
        return out

    def collectable(self, evictable: Callable[[int], bool],
                    protect: Sequence[int] = ()) -> int:
        """How many pages an eviction cascade could free right now —
        leaves first, then parents exposed by their removal. Used for
        admission headroom (``GenerationEngine.available_pages``)."""
        guard = set(int(p) for p in protect)
        # simulate the cascade on child-counts without touching the tree
        pending: Dict[int, int] = {}   # id(node) -> live children
        nodes: List[_Node] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            nodes.append(node)
            pending[id(node)] = len(node.children)
            stack.extend(node.children.values())
        freed, frontier = 0, [nd for nd in nodes
                              if nd is not self._root and not nd.children]
        while frontier:
            nxt: List[_Node] = []
            for leaf in frontier:
                if leaf.page in guard or not evictable(leaf.page):
                    continue
                freed += 1
                parent = leaf.parent
                if parent is not self._root:
                    pending[id(parent)] -= 1
                    if pending[id(parent)] == 0:
                        nxt.append(parent)
            frontier = nxt
        return freed

    def pages(self) -> List[int]:
        """Every page id the cache currently references."""
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root:
                out.append(node.page)
            stack.extend(node.children.values())
        return out

    def clear(self) -> List[int]:
        """Drop everything; returns the previously referenced page ids."""
        out = self.pages()
        self._root = _Node(None, None, None)
        self._count = 0
        return out
