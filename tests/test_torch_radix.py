"""The port's radix trees and page pool (``repro_torch.serving.radix``,
``pool``) against the JAX package's: the tests of ``tests/test_radix.py``
(match, split, refcounts, locks, LRU and warmth order, the dual fork's hit
kinds, and two hypothesis properties), each run on the port, and each
scenario's observables (matched lengths, page ids, refcounts, eviction
counts, hit kinds) also equal to the reference's on the same operations.

Each scenario is written once against a :class:`Side` (one package's
``PagePool``, ``RadixTree`` and ``DualRadixTree``).  Pure host-side
bookkeeping: no model, no tensors.
"""
import dataclasses
from typing import Any

from hypothesis import HealthCheck, given, settings, strategies as st

from repro.serving import pool as jpool
from repro.serving import radix as jradix
from repro_torch.serving import pool as tpool
from repro_torch.serving import radix as tradix

PAGE = 4


@dataclasses.dataclass
class Side:
    """One package's page pool and radix tree classes."""
    PagePool: Any
    RadixTree: Any
    DualRadixTree: Any

    def tree(self, pages=256):
        pool = self.PagePool(pages, PAGE)
        return self.RadixTree(pool), pool

    def dual(self, pages=64):
        bp, rp = self.PagePool(pages, PAGE), self.PagePool(pages, PAGE)
        return self.DualRadixTree(bp, rp), bp, rp


PORT = Side(tpool.PagePool, tradix.RadixTree, tradix.DualRadixTree)
REF = Side(jpool.PagePool, jradix.RadixTree, jradix.DualRadixTree)


def both(script, *args):
    """``script`` run on the port and on the reference: the port's result,
    after checking that the reference's is the same."""
    got, want = script(PORT, *args), script(REF, *args)
    assert got == want, (got, want)
    return got


def insert_seq(tree, pool, toks):
    n = len(toks) // PAGE
    pages = pool.alloc(max(n, 0)) or []
    tree.insert(toks, pages)
    return pages


def match(tree, toks):
    got, matched, _ = tree.match_prefix(toks)
    return list(got), matched


def walk_locks(node):
    return [node.lock_ref] + [x for c in node.children.values()
                              for x in walk_locks(c)]


def fork_view(fr):
    return (fr.hit_kind, fr.reuse_len, fr.base_len, fr.res_len,
            list(fr.base_pages), list(fr.res_pages))


# ----------------------------------------------------------------- scripts
def exact(side):
    t, pool = side.tree()
    toks = list(range(16))
    pages = insert_seq(t, pool, toks)
    return pages, match(t, toks)


def split(side):
    t, pool = side.tree()
    toks = list(range(20))
    insert_seq(t, pool, toks)
    short = match(t, toks[:10])
    diverging = match(t, toks[:12] + [99] * 8)
    return short[1], diverging[1]


def refcounts(side):
    t, pool = side.tree()
    pages = insert_seq(t, pool, list(range(16)))
    owned = [pool.refcount(p) for p in pages]
    pool.decref(pages)
    tree_only = [pool.refcount(p) for p in pages]
    t.evict(len(pages))
    return owned, tree_only, [pool.refcount(p) for p in pages]


def locks(side):
    t, pool = side.tree(pages=8)
    toks = list(range(16))
    pool.decref(insert_seq(t, pool, toks))
    _, _, path = t.match_prefix(toks, lock=True)
    locked = t.evict(4)
    t.unlock_path(path)
    return locked, t.evict(4)


def foreign_split(side):
    t, pool = side.tree()
    toks = list(range(16))
    pool.decref(insert_seq(t, pool, toks))
    _, _, path = t.match_prefix(toks, lock=True)
    t.match_prefix(toks[:8])             # a second request splits the node
    t.unlock_path(path)
    return t.evict(4), walk_locks(t.root)


def lru(side):
    t, pool = side.tree()
    a, b = [1] * 8, [2] * 8
    pool.decref(insert_seq(t, pool, a))
    pool.decref(insert_seq(t, pool, b))
    t.match_prefix(a)                    # touch a -> b becomes LRU
    t.evict(2)
    return match(t, a)[1], match(t, b)[1]


def dual_kinds(side):
    dual, bp, rp = side.dual()
    toks = list(range(16))
    bpages, rpages = bp.alloc(4), rp.alloc(4)
    out = [fork_view(dual.fork(toks, adapter_id=0, lock=False))]
    dual.commit(toks, 0, bpages, rpages)
    out.append(fork_view(dual.fork(toks, adapter_id=0, lock=False)))
    out.append(fork_view(dual.fork(toks, adapter_id=1, lock=False)))
    dual.base.evict(4)                   # decoupled eviction: base only
    out.append(fork_view(dual.fork(toks, adapter_id=0, lock=False)))
    return out


def warmth(side):
    t, pool = side.tree(pages=4)
    warm_toks, cold_toks = [1] * PAGE, [2] * PAGE
    pool.decref(insert_seq(t, pool, warm_toks))
    pool.decref(insert_seq(t, pool, cold_toks))
    path, pinned = t.pin(warm_toks)      # a session pins its context...
    t.unpin(path)                        # ...and closes: warm, unpinned
    t.match_prefix(cold_toks)            # the cold entry is now MRU
    t.evict(1)
    first = (match(t, warm_toks)[1], match(t, cold_toks)[1])
    t.evict(1)
    return pinned, first, match(t, warm_toks)[1]


def prefix_property(side, seqs):
    pool = side.PagePool(1024, PAGE)
    tree = side.RadixTree(pool)
    owned, matches = [], []
    for toks in seqs:
        n = len(toks) // PAGE
        pages = pool.alloc(n) if n else []
        assert pages is not None
        owned.append(pages)
        tree.insert(toks, pages)
        got, matched = match(tree, toks)
        assert matched % PAGE == 0 and matched <= len(toks)
        assert len(got) == matched // PAGE
        matches.append((got, matched))
    refs = {}

    def walk(n):
        for p in n.pages:
            refs[p] = refs.get(p, 0) + 1
        for c in n.children.values():
            walk(c)

    walk(tree.root)
    for pages in owned:
        for p in pages:
            assert pool.refcount(p) == 1 + refs.get(p, 0)
    return matches, sorted(refs.items())


def reuse_property(side, inserts, evictions):
    dual, bp, rp = side.dual(pages=512)
    for aid, toks in inserts:
        n = len(toks) // PAGE
        dual.commit(toks, aid, bp.alloc(n) or [], rp.alloc(n) or [])
    dual.base.evict(evictions)
    out = []
    for aid, toks in inserts:
        fr = dual.fork(toks, aid, lock=False)
        assert fr.reuse_len == min(fr.base_len, fr.res_len)
        assert fr.base_len % PAGE == 0 and fr.res_len % PAGE == 0
        assert fr.base_len <= len(toks) and fr.res_len <= len(toks)
        assert len(fr.base_pages) == fr.base_len // PAGE
        assert len(fr.res_pages) == fr.res_len // PAGE
        out.append(fork_view(fr))
    return out


# ------------------------------------------------------------------- tests
def test_match_after_insert_exact():
    pages, (got, matched) = both(exact)
    assert matched == 16 and got == pages


def test_partial_match_splits_node():
    # the page-aligned prefix of the split node; a diverging branch shares
    # the common prefix pages
    assert both(split) == (8, 12)


def test_shared_pages_refcounted():
    owned, tree_only, evicted = both(refcounts)
    assert owned == [2] * 4              # caller + tree
    assert tree_only == [1] * 4          # the tree keeps them alive
    assert evicted == [0] * 4


def test_eviction_respects_locks():
    locked, unlocked = both(locks)
    assert locked == 0                   # locked: nothing evictable
    assert unlocked >= 4


def test_unlock_after_foreign_split_releases_head():
    """Splitting a LOCKED node copies the lock onto the new head; the
    locker's unlock must release the head too, or it stays pinned."""
    evicted, lock_refs = both(foreign_split)
    assert evicted >= 4
    assert set(lock_refs) == {0}


def test_lru_order():
    assert both(lru) == (8, 0)


def test_dual_fork_kinds():
    miss, full, partial_res, partial_base = both(dual_kinds)
    assert miss[0] == "miss"
    assert full[:2] == ("full", 16)
    # another adapter: the base hits, the residual misses (CoW)
    assert partial_res[0] == "partial_res" and partial_res[2:4] == (16, 0)
    # base evicted alone: recompute xW only
    assert partial_base[0] == "partial_base" and partial_base[2:4] == (0, 16)


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(st.lists(st.lists(st.integers(0, 3), min_size=1, max_size=40),
                min_size=1, max_size=12))
def test_property_match_is_prefix_and_refcounts_consistent(seqs):
    """Any insert sequence: every match is a true page-aligned prefix, and
    a page's refcount is 1 (owner) + the tree nodes referencing it."""
    both(prefix_property, seqs)


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(st.lists(st.tuples(st.integers(0, 3),
                          st.lists(st.integers(0, 2), min_size=4,
                                   max_size=32)),
                min_size=1, max_size=10),
       st.integers(0, 30))
def test_property_dual_fork_reuse_bounded(inserts, evictions):
    """fork(): reuse <= min(base_len, res_len) <= prompt length, all
    page-aligned, under arbitrary inserts and evictions."""
    both(reuse_property, inserts, evictions)


def test_warm_context_outranks_cold_cache_in_eviction():
    """Session-aware eviction (DESIGN.md §15): an unpinned but warm
    context is evicted only after cold cache, even when the cold entry was
    used more recently; warmth is a rank, not a lock."""
    pinned, (warm, cold), warm_later = both(warmth)
    assert pinned == PAGE
    assert warm == PAGE and cold == 0
    assert warm_later == 0


def test_session_script_matches_reference():
    """A longer deterministic script over both trees — pins, commits under
    three adapters, locked forks, releases, decoupled evictions — ends in
    the same page ids, hit kinds, free counts and pin lengths."""
    def script(side):
        dual, bp, rp = side.dual(pages=24)
        out = []
        ctx = list(range(24))
        for aid in (0, 1, 2):
            toks = ctx + [50 + aid] * 8
            n = len(toks) // PAGE
            fr = dual.fork(toks, aid, lock=True)
            out.append(fork_view(fr))
            dual.commit(toks, aid, bp.alloc(n), rp.alloc(n))
            dual.release(fr, aid)
        handle = dual.pin(ctx, 0)
        out.append(handle[2])
        for n in (3, 9, 30):
            dual.base.evict(n)
            dual.residual.evict(n)
            out.append((bp.free_pages, rp.free_pages))
            out.append([fork_view(dual.fork(ctx + [50 + a] * 8, a,
                                            lock=False))
                        for a in (0, 1, 2)])
        dual.unpin(handle, 0)
        dual.base.evict(30)
        dual.residual.evict(30)
        out.append((bp.free_pages, rp.free_pages))
        return out

    got = both(script)
    assert got[-1][0] < 24              # the callers' refs remain
