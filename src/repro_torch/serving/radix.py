"""Radix trees over token sequences + the ForkKV DualRadixTree (paper §5.2).

A RadixTree maps token sequences to lists of KV pages (page_size tokens per
page).  Nodes are page-aligned segments; matched pages are shared zero-copy
via the pool's refcounts.  Eviction is LRU over *leaf* nodes, never evicting
nodes locked by in-flight requests.

With a tiered pool (``pool.is_tiered``, DESIGN.md §10) eviction first tries
to DEMOTE the victim to host memory: the node stays in the tree tagged
``tier == "host"`` with its ``pages`` list holding host handles, and its
device pages are freed.  ``match_prefix`` transparently PROMOTES host-tier
nodes back into device pages as it walks (a *tier hit*), locking the path
while it works so concurrent eviction pressure cannot free pages under the
match.  Only when both the device pool and the host budget are exhausted
does eviction destroy bytes (the seed behaviour).

DualRadixTree composes two trees with DECOUPLED lifecycles:
  * base tree    — key = token ids           → bCache pages (shared across
    agents, the "parent process pages")
  * residual tree— key = (adapter id ‖ ids)  → rCache pages (per-agent CoW
    footprint, the "child process pages")

``fork()`` implements the OS-style fork: longest-prefix match inherits the
shared bCache, then exclusive rCache pages are allocated (copy-on-write).
A *partial hit* (base evicted, residual alive — or vice versa) degrades
gracefully: only the missing component is recomputed (paper's decoupled
eviction policy).
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.pool import PagePool

_counter = itertools.count()


def _adjust_chain(node: Optional["Node"], attr: str, delta: int) -> None:
    """Adjust a reference counter (``lock_ref``/``pin_ref``) along the
    CURRENT parent chain from ``node`` to the root.  The shared walk for
    lock release and pin take/release: counters cover the whole path and
    survive splits (the head copies them), so correctness depends on
    walking parents as they are NOW, not as they were recorded."""
    while node is not None:
        value = getattr(node, attr) + delta
        assert value >= 0, (attr, value)
        setattr(node, attr, value)
        node = node.parent


class Node:
    __slots__ = ("key", "pages", "children", "parent", "last_access",
                 "lock_ref", "pin_ref", "tier", "warm")

    def __init__(self, key: Tuple[int, ...], pages: List[int],
                 parent: Optional["Node"]):
        self.key = key                  # token segment (page-aligned length)
        self.pages = pages              # device pages, or host handles when
                                        # tier == "host" (DESIGN.md §10)
        self.children: Dict[int, Node] = {}
        self.parent = parent
        self.last_access = next(_counter)
        self.lock_ref = 0               # transient: held per in-flight request
        self.pin_ref = 0                # long-lived: held per AgentSession
                                        # (DESIGN.md §11) — blocks eviction
                                        # AND demotion for the session's life
        self.tier = "device"            # device | host | disk
        self.warm = False               # was ever session-pinned: after the
                                        # pin drops, the context stays ranked
                                        # ABOVE cold cache in eviction order
                                        # (DESIGN.md §15) until it is
                                        # demoted/evicted once


class RadixTree:
    """Page-aligned radix tree over token sequences."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = Node((), [], None)
        self.hits_tokens = 0
        self.miss_tokens = 0
        self.evicted_pages = 0
        self.demoted_pages = 0

    # ----------------------------------------------------------- matching
    def match_prefix(self, tokens: Sequence[int], lock: bool = False,
                     promote: bool = True) -> Tuple[List[int], int,
                                                    List[Node]]:
        """Longest page-aligned prefix match.

        Returns (pages, matched_tokens, path_nodes).  If ``lock``, every
        node on the path gets lock_ref+1 (caller must unlock_path later).

        The path is locked incrementally DURING the walk (and unlocked at
        the end unless ``lock``): with a tiered pool, promoting a host-tier
        node may apply eviction pressure, and the walk's own pages must not
        be demoted under it.  Host-tier nodes on the path are promoted back
        to device pages (a tier hit); a failed promotion truncates the
        match — a graceful partial hit, never a corrupt one.

        ``promote=False`` (used by :meth:`insert`, which only needs the
        match POSITION) traverses host-tier nodes without touching their
        bytes instead of paying H2D copies for pages the caller will
        never read; the returned ``pages`` then cover only the device
        portion and may be shorter than ``matched`` implies.
        """
        tokens = tuple(tokens)
        page = self.pool.page_size
        tiered = getattr(self.pool, "is_tiered", False)
        if tiered:
            self.pool.begin_match()
        node = self.root
        pages: List[int] = []
        matched = 0
        path = [self.root]
        self.root.lock_ref += 1
        try:
            while matched < len(tokens):
                child = node.children.get(tokens[matched])
                if child is None:
                    break
                rest = tokens[matched:]
                common = 0
                for a, b in zip(child.key, rest):
                    if a != b:
                        break
                    common += 1
                common = (common // page) * page   # page-aligned sharing only
                if common == 0:
                    break
                if common < len(child.key):
                    child = self._split(child, common)  # split; take the head
                if child.tier != "device" and promote:
                    room = self.pool.promote_room() if tiered else None
                    if room == 0:
                        break            # per-match promote budget spent
                    if room is not None and len(child.pages) > room:
                        # promote only the head the budget allows; the tail
                        # stays on host for a later match to pick up
                        child = self._split(child, room * page)
                child.lock_ref += 1
                try:
                    ok = child.tier == "device" or not promote or (
                        tiered and self.pool.promote_node(child))
                except BaseException:
                    child.lock_ref -= 1
                    raise
                if not ok:
                    child.lock_ref -= 1
                    break                # host budget / device pool exhausted
                if child.tier == "device":
                    pages.extend(child.pages)
                matched += len(child.key)
                node = child
                node.last_access = next(_counter)
                path.append(node)
        except BaseException:
            # a failed promotion copy must not leave the walk's locks
            # behind — a leaked lock pins pages against eviction forever
            self.unlock_path(path)
            raise
        if not lock:
            self.unlock_path(path)
        return pages, matched, path

    def _split(self, child: Node, keep: int) -> Node:
        """Split ``child`` at page-aligned token offset ``keep``; returns the
        new head node covering key[:keep]."""
        page = self.pool.page_size
        assert keep % page == 0 and 0 < keep < len(child.key)
        kp = keep // page
        head = Node(child.key[:keep], child.pages[:kp], child.parent)
        head.last_access = child.last_access
        head.lock_ref = child.lock_ref       # locks cover the whole path
        head.pin_ref = child.pin_ref         # ...and so do session pins
        head.warm = child.warm               # ...and the warmth marker
        head.tier = child.tier
        if head.tier != "device" and getattr(self.pool, "is_tiered", False):
            self.pool.retarget(head.pages, head)   # handles moved to head
        child.parent.children[head.key[0]] = head
        child.key = child.key[keep:]
        child.pages = child.pages[kp:]
        child.parent = head
        head.children[child.key[0]] = child
        return head

    def unlock_path(self, path: List[Node]) -> None:
        """Release the locks taken by a previous match (lock=True).

        Walks the CURRENT parent chain from the deepest locked node rather
        than the recorded list: a later match may have split a locked node,
        copying the lock onto the new head — a node the recorded list
        cannot know about.  Every node on the chain carries exactly one
        lock per locker, so one decrement each settles the account (and
        with tiers, leaves nothing permanently pinned against eviction).
        """
        if path:
            _adjust_chain(path[-1], "lock_ref", -1)

    # ------------------------------------------------------------- pinning
    def pin(self, tokens: Sequence[int]) -> Tuple[List[Node], int]:
        """Pin the cached prefix of ``tokens`` against eviction/demotion.

        Session-lifetime locks (DESIGN.md §11), DISTINCT from the transient
        per-request ``lock_ref`` a match takes: a pin survives arbitrarily
        many requests and is only dropped by :meth:`unpin` (session close).
        Returns ``(path, matched_tokens)``; the caller keeps the path as
        its unpin handle.  Host-tier nodes on the path are promoted first
        (a pinned prefix is always device-resident).
        """
        _, matched, path = self.match_prefix(tokens)
        # pins cover the whole path, same convention as locks
        _adjust_chain(path[-1], "pin_ref", +1)
        # session-aware eviction rank (DESIGN.md §15): mark the pinned
        # context warm, so after unpin it still outranks cold cache in
        # LRU order — an agent tree's context is the likeliest re-hit
        for node in path:
            node.warm = True
        return path, matched

    def unpin(self, path: List[Node]) -> None:
        """Release a session pin.  Walks the CURRENT parent chain from the
        deepest pinned node (splits copy ``pin_ref`` onto new heads exactly
        as they copy ``lock_ref`` — see :meth:`unlock_path`)."""
        if path:
            _adjust_chain(path[-1], "pin_ref", -1)

    # ----------------------------------------------------------- insertion
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Insert a fully page-aligned sequence owning ``pages``.

        The tree takes one reference on every NEW page it stores (caller
        keeps its own reference).  Returns number of pages newly adopted.
        """
        tokens = tuple(tokens)
        page_size = self.pool.page_size
        assert len(pages) >= len(tokens) // page_size, \
            "pages must cover every full page of tokens"
        _, matched, path = self.match_prefix(tokens, promote=False)
        node = path[-1]
        # only full pages are insertable; trailing partial page stays private
        full_tokens = (len(tokens) // page_size) * page_size
        if matched >= full_tokens:
            return 0
        new_tokens = tokens[matched:full_tokens]
        new_pages = list(pages[matched // page_size:full_tokens // page_size])
        if not new_pages:
            return 0
        if new_tokens[0] in node.children:
            # sibling shares a sub-page prefix: pages are page-granular so
            # nothing can be shared — skip the insert (rare; documented
            # limitation of page-aligned radix caching, as in SGLang)
            return 0
        child = Node(tuple(new_tokens), new_pages, node)
        node.children[new_tokens[0]] = child
        self.pool.incref(new_pages)
        return len(new_pages)

    def graft_host(self, tokens: Sequence[int], blobs) -> int:
        """Attach a host-tier node holding ``blobs`` for the page-aligned
        suffix of ``tokens`` not already present (restore path, DESIGN.md
        §18).  ``blobs`` are LOGICAL (decoded) page blobs covering exactly
        the suffix; they are encoded with the pool's codec and stored in
        the host tier, so the first match promotes them like any demoted
        node — the restored context costs zero device pages until used.

        Restores are best-effort: a sub-page divergence from existing
        content, a missing tier, or a full host budget skips the graft
        (returns 0) rather than failing the restart.
        """
        if not getattr(self.pool, "is_tiered", False):
            return 0
        tokens = tuple(tokens)
        page_size = self.pool.page_size
        node = self.root
        matched = 0
        # whole-segment walk only: persist records arrive parent-first, so
        # the prefix (if restored) exists as complete nodes
        while matched < len(tokens):
            child = node.children.get(tokens[matched])
            if child is None or tokens[matched:matched + len(child.key)] \
                    != child.key:
                break
            matched += len(child.key)
            node = child
        new_tokens = tokens[matched:]
        if not new_tokens or len(new_tokens) != len(blobs) * page_size:
            return 0
        if new_tokens[0] in node.children:
            return 0
        handles = self.pool.host_put_blobs(blobs)
        if handles is None:
            return 0
        child = Node(tuple(new_tokens), handles, node)
        child.tier = "host"
        node.children[new_tokens[0]] = child
        self.pool.adopt_host_handles(handles, child)
        return len(handles)

    # ------------------------------------------------------------ eviction
    def _leaves(self) -> List[Node]:
        """Device-frontier nodes: device-resident with no device-resident
        descendant.  For a non-tiered pool this is exactly the leaf set;
        with tiers it lets eviction walk UP the tree as leaves demote."""
        out = []
        root = self.root

        def walk(n: Node) -> bool:           # subtree holds a device node?
            has_device_below = False
            for c in n.children.values():
                if walk(c):
                    has_device_below = True
            is_device = n is not root and n.tier == "device"
            if is_device and not has_device_below:
                out.append(n)
            return is_device or has_device_below

        walk(root)
        return out

    def evict(self, n_pages: int) -> int:
        """Free ≥ n_pages device pages from LRU unlocked victims.

        Tiered pool: victims are DEMOTED to the host tier (node survives,
        bytes preserved) and only truly evicted when the host budget is
        exhausted too.  Non-tiered: destroy, as in the seed engine.
        """
        freed = 0
        skipped = set()
        while freed < n_pages:
            leaves = [l for l in self._leaves()
                      if l.lock_ref == 0 and l.pin_ref == 0
                      and id(l) not in skipped]
            if not leaves:
                break
            # cold cache first: unpinned-but-warm session contexts rank
            # above never-pinned nodes, falling back to plain LRU within
            # each class (DESIGN.md §15)
            victim = min(leaves, key=lambda n: (n.warm, n.last_access))
            got = _evict_one(self, victim)
            if got == 0:
                skipped.add(id(victim))
                continue
            freed += got
        return freed

    def total_nodes(self) -> int:
        n = 0

        def walk(node):
            nonlocal n
            n += 1
            for c in node.children.values():
                walk(c)

        walk(self.root)
        return n - 1


def _evict_one(owner, victim: Node) -> int:
    """Demote (tiered pool) or destroy one victim node.

    ``owner`` is the RadixTree or ResidualForest doing the eviction (it
    carries ``pool`` and the evicted/demoted counters).  Returns the number
    of device pages that ACTUALLY became free (a destroyed victim whose
    pages are still co-owned by a running request frees nothing yet —
    reporting its page count would let allocation pressure falsely claim
    room was made).  ``evicted_pages`` still counts cache entries lost.
    A demoted victim stays in the tree; a destroyed one is unlinked,
    taking any host-tier children with it (a device-frontier victim has
    no device-resident descendants, so nothing else can be orphaned).
    """
    pool = owner.pool
    n = len(victim.pages)
    victim.warm = False          # a pushed-out context spent its warmth:
                                 # next time it competes as plain LRU
    if getattr(pool, "is_tiered", False):
        if pool.demote_node(victim):
            owner.demoted_pages += n
            return n                     # refcount==1 guard: all freed
        if victim.children and any(pool.refcount(p) > 1
                                   for p in victim.pages):
            # transiently shared (e.g. a broadcast co-owner still running)
            # with preserved host state below: destroying it would lose
            # the subtree as collateral — skip, let the caller try the
            # next LRU candidate
            return 0
        freed = len(pool.decref(victim.pages))
        for child in list(victim.children.values()):
            pool._drop_subtree(child)
        del victim.parent.children[victim.key[0]]
        owner.evicted_pages += n
        return freed
    freed = len(pool.decref(victim.pages))
    del victim.parent.children[victim.key[0]]
    owner.evicted_pages += n
    return freed


class ForkResult:
    __slots__ = ("base_pages", "base_len", "res_pages", "res_len",
                 "reuse_len", "base_path", "res_path", "hit_kind")

    def __init__(self, base_pages, base_len, res_pages, res_len, reuse_len,
                 base_path, res_path, hit_kind):
        self.base_pages = base_pages
        self.base_len = base_len
        self.res_pages = res_pages
        self.res_len = res_len
        self.reuse_len = reuse_len      # tokens whose BOTH caches are live
        self.base_path = base_path
        self.res_path = res_path
        self.hit_kind = hit_kind        # full | partial_base | partial_res |
                                        # partial_both | miss


class ResidualForest:
    """The residual radix tree: Key_res = (adapter id ‖ token ids).

    Implemented as one namespace (sub-tree) per adapter id over a SHARED
    page pool — equivalent to prefixing the key with the agent id (paper
    §5.2) while keeping every namespace page-aligned.  LRU eviction is
    global across namespaces (one lifecycle for the whole rCache pool).
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.trees: Dict[int, RadixTree] = {}
        self.evicted_pages = 0
        self.demoted_pages = 0

    def tree(self, adapter_id: int) -> RadixTree:
        if adapter_id not in self.trees:
            self.trees[adapter_id] = RadixTree(self.pool)
        return self.trees[adapter_id]

    def match_prefix(self, adapter_id: int, tokens, lock=False):
        return self.tree(adapter_id).match_prefix(tokens, lock=lock)

    def insert(self, adapter_id: int, tokens, pages) -> int:
        return self.tree(adapter_id).insert(tokens, pages)

    def pin(self, adapter_id: int, tokens) -> Tuple[List[Node], int]:
        return self.tree(adapter_id).pin(tokens)

    def unpin(self, adapter_id: int, path: List[Node]) -> None:
        self.tree(adapter_id).unpin(path)

    def evict(self, n_pages: int) -> int:
        """Global LRU across namespaces; demotes before destroying (tiered
        pools), exactly as :meth:`RadixTree.evict`."""
        freed = 0
        skipped = set()
        while freed < n_pages:
            candidates = []
            for t in self.trees.values():
                candidates.extend(l for l in t._leaves()
                                  if l.lock_ref == 0 and l.pin_ref == 0
                                  and id(l) not in skipped)
            if not candidates:
                break
            victim = min(candidates, key=lambda n: (n.warm, n.last_access))
            got = _evict_one(self, victim)
            if got == 0:
                skipped.add(id(victim))
                continue
            freed += got
        return freed


class DualRadixTree:
    """ForkKV's coordinated dual-tree storage with fork/CoW semantics."""

    def __init__(self, base_pool: PagePool, res_pool: PagePool):
        self.base = RadixTree(base_pool)
        self.residual = ResidualForest(res_pool)
        self.fork_count = 0
        self.hit_kinds: Dict[str, int] = {}

    def fork(self, tokens: Sequence[int], adapter_id: int,
             lock: bool = True) -> ForkResult:
        """OS-style fork: inherit shared bCache, locate private rCache."""
        self.fork_count += 1
        b_pages, b_len, b_path = self.base.match_prefix(tokens, lock=lock)
        r_pages, r_len, r_path = self.residual.match_prefix(
            adapter_id, tokens, lock=lock)
        reuse = min(b_len, r_len)
        if b_len == 0 and r_len == 0:
            kind = "miss"
        elif reuse == b_len == r_len and reuse > 0:
            kind = "full"
        elif b_len < r_len:
            kind = "partial_base"       # base evicted: recompute xW only
        elif r_len < b_len:
            kind = "partial_res"        # residual missing: CoW-fill xA_i
        else:
            kind = "partial_both" if reuse else "miss"
        self.hit_kinds[kind] = self.hit_kinds.get(kind, 0) + 1
        # the paper's cache-hit metric (Fig 14b) counts bCache reuse: the
        # massive shared component; rCache reuse additionally skips the
        # residual prefill entirely (full hit)
        self.base.hits_tokens += b_len
        self.base.miss_tokens += len(tokens) - b_len
        self.residual.tree(adapter_id).hits_tokens += r_len
        self.residual.tree(adapter_id).miss_tokens += len(tokens) - r_len
        return ForkResult(b_pages, b_len, r_pages, r_len, reuse,
                          b_path if lock else None,
                          r_path if lock else None, kind)

    def commit(self, tokens: Sequence[int], adapter_id: int,
               base_pages: Sequence[int], res_pages: Sequence[int]) -> None:
        """After generation: publish this agent's caches into both trees."""
        self.base.insert(tokens, base_pages)
        self.residual.insert(adapter_id, tokens, res_pages)

    def pin(self, tokens: Sequence[int], adapter_id: int):
        """Session pin over BOTH trees: the shared bCache prefix plus the
        session adapter's rCache prefix (DESIGN.md §11)."""
        b_path, b_len = self.base.pin(tokens)
        r_path, r_len = self.residual.pin(adapter_id, tokens)
        return (b_path, r_path, min(b_len, r_len))

    def unpin(self, handle, adapter_id: int) -> None:
        b_path, r_path, _ = handle
        self.base.unpin(b_path)
        self.residual.unpin(adapter_id, r_path)

    def release(self, fr: ForkResult, adapter_id: int) -> None:
        if fr.base_path is not None:
            self.base.unlock_path(fr.base_path)
        if fr.res_path is not None:
            self.residual.tree(adapter_id).unlock_path(fr.res_path)
