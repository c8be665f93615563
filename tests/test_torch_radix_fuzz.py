"""Property fuzz of the port's radix/CoW/tier lifecycle
(``repro_torch.serving.radix``, ``pool``, ``tiers``), held to a
dict-of-tokens oracle as ``tests/test_radix_fuzz.py`` holds the reference,
and run in lock step with the reference on the same draws.

Random interleavings of fork / append (commit) / evict / pin / unpin over a
``DualRadixTree`` on two ``TieredPagePool`` s: every KV page carries its own
tokens as content (fake export/import callbacks), so a refcount, CoW or
tier-transition fault surfaces as a content mismatch on a later match.
After every operation: no leaked transient lock, device nodes own live
pages and no page is owned twice, host nodes hold live handles, pool
accounting never drifts, pinned prefixes keep matching in full, matched
pages hold exactly the tokens they claim; and the port's forks, free
counts and tier counters equal the reference's.
"""
import numpy as np
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.serving import pool as jpool
from repro.serving import radix as jradix
from repro.serving import tiers as jtiers
from repro_torch.serving import pool as tpool
from repro_torch.serving import radix as tradix
from repro_torch.serving import tiers as ttiers

PAGE = 4
N_PAGES = 24
ADAPTERS = (0, 1)
TIER_COUNTERS = ("tier_hits", "demoted_pages", "promoted_pages",
                 "host_evicted_pages", "dropped_device_pages")


class FuzzHarness:
    """A DualRadixTree over two tiered pools of one package + a
    dict-of-tokens oracle."""

    def __init__(self, pool_mod, radix_mod, tiers_mod, host_budget_bytes,
                 promote_limit):
        self.host = tiers_mod.HostTier(host_budget_bytes)
        self.mem = {"base": {}, "res": {}}      # page id -> token ndarray
        self.base_pool = tiers_mod.TieredPagePool(
            pool_mod.PagePool(N_PAGES, PAGE, "base"), self.host,
            promote_limit=promote_limit)
        self.res_pool = tiers_mod.TieredPagePool(
            pool_mod.PagePool(N_PAGES, PAGE, "residual"), self.host,
            promote_limit=promote_limit)
        self.dual = radix_mod.DualRadixTree(self.base_pool, self.res_pool)
        self.base_pool.bind(
            export_fn=lambda p: self._export("base", p),
            import_fn=lambda p, b: self._import("base", p, b),
            pressure_fn=lambda n: self.dual.base.evict(n))
        self.res_pool.bind(
            export_fn=lambda p: self._export("res", p),
            import_fn=lambda p, b: self._import("res", p, b),
            pressure_fn=lambda n: self.dual.residual.evict(n))
        self.committed = []                     # (tokens tuple, adapter_id)
        self.pinned = []                        # (tokens, aid, handle, len)

    # fake device<->host byte movement: one page blob = its tokens
    def _export(self, kind, pages):
        return [{"d": self.mem[kind][p].copy()} for p in pages]

    def _import(self, kind, pages, blobs):
        for p, b in zip(pages, blobs):
            self.mem[kind][p] = b["d"].copy()

    def _alloc(self, pool, evict, n):
        if n == 0:
            return []
        pages = pool.alloc(n)
        if pages is None:
            evict(n - pool.free_pages)
            pages = pool.alloc(n)
        return pages

    # --------------------------------------------------------------- ops
    def commit(self, tokens, aid):
        """Engine-style publish: alloc pages for the whole sequence, write
        their contents, insert into both trees, drop the local refs."""
        n = len(tokens) // PAGE
        base_pages = self._alloc(self.base_pool, self.dual.base.evict, n)
        if base_pages is None:
            return None
        res_pages = self._alloc(self.res_pool, self.dual.residual.evict, n)
        if res_pages is None:
            self.base_pool.decref(base_pages)
            return None
        for i in range(n):
            chunk = np.asarray(tokens[i * PAGE:(i + 1) * PAGE], np.int64)
            self.mem["base"][base_pages[i]] = chunk.copy()
            self.mem["res"][res_pages[i]] = chunk.copy()
        self.dual.commit(tokens, aid, base_pages, res_pages)
        self.base_pool.decref(base_pages)
        self.res_pool.decref(res_pages)
        if (tuple(tokens), aid) not in self.committed:
            self.committed.append((tuple(tokens), aid))
        return list(base_pages), list(res_pages)

    def fork(self, tokens, aid):
        """fork + oracle check + release: whatever prefix the trees claim
        to have cached must hold exactly those tokens."""
        fr = self.dual.fork(tokens, aid, lock=True)
        try:
            for kind, matched, pages in (("base", fr.base_len,
                                          fr.base_pages),
                                         ("res", fr.res_len, fr.res_pages)):
                assert matched % PAGE == 0
                assert len(pages) == matched // PAGE, (kind, matched, pages)
                for i, p in enumerate(pages):
                    want = np.asarray(tokens[i * PAGE:(i + 1) * PAGE],
                                      np.int64)
                    np.testing.assert_array_equal(
                        self.mem[kind][p], want,
                        err_msg=f"{kind} page {p} holds foreign tokens")
            assert fr.reuse_len == min(fr.base_len, fr.res_len)
            return (fr.hit_kind, fr.base_len, fr.res_len,
                    list(fr.base_pages), list(fr.res_pages))
        finally:
            self.dual.release(fr, aid)

    def pin(self, tokens, aid):
        handle = self.dual.pin(tokens, aid)
        self.pinned.append((tokens, aid, handle, handle[2]))
        return handle[2]

    def unpin(self, idx):
        tokens, aid, handle, _ = self.pinned.pop(idx % len(self.pinned))
        self.dual.unpin(handle, aid)

    # -------------------------------------------------------- invariants
    def _iter_nodes(self, root):
        stack = list(root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def check(self):
        for pool, trees in ((self.base_pool, [self.dual.base]),
                            (self.res_pool,
                             list(self.dual.residual.trees.values()))):
            seen = set()
            for tree in trees:
                for node in self._iter_nodes(tree.root):
                    assert node.lock_ref == 0, "leaked transient lock"
                    assert node.pin_ref >= 0
                    if node.tier == "device":
                        for p in node.pages:
                            assert pool.refcount(p) >= 1, \
                                "tree references a freed page"
                            assert p not in seen, "page owned by two nodes"
                            seen.add(p)
                    else:
                        for h in node.pages:
                            assert h in self.host, \
                                "host node references a dropped handle"
            inner = pool.pool
            assert inner.free_pages + inner.used_pages == inner.num_pages
        assert self.host.used_bytes >= 0
        # pinned prefixes are immune to eviction AND demotion
        for tokens, aid, _, mlen in self.pinned:
            fr = self.dual.fork(tokens, aid, lock=False)
            assert fr.reuse_len >= mlen, "pinned prefix lost cache"

    def state(self):
        """What the reference must agree on after each operation."""
        return (self.base_pool.pool.free_pages, self.res_pool.pool.free_pages,
                self.host.used_bytes,
                [getattr(p, k) for p in (self.base_pool, self.res_pool)
                 for k in TIER_COUNTERS])

    def teardown(self):
        while self.pinned:
            self.unpin(0)
        self.dual.base.evict(N_PAGES)
        self.dual.residual.evict(N_PAGES)
        self.check()
        # no pins and full eviction pressure: every device page must be
        # reclaimable — anything less is a refcount leak
        assert self.base_pool.pool.free_pages == N_PAGES
        assert self.res_pool.pool.free_pages == N_PAGES


def seqs(draw):
    """A page-aligned token sequence (1–4 pages, a tiny alphabet so radix
    paths branch and share)."""
    return draw(st.lists(st.integers(0, 4), min_size=PAGE,
                         max_size=4 * PAGE).map(
        lambda t: t[:len(t) // PAGE * PAGE]))


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(data=st.data())
def test_radix_cow_tier_fuzz(data):
    host_budget = data.draw(st.sampled_from([0, 2 * PAGE * 8, 10 ** 6]),
                            label="host_budget")
    promote_limit = data.draw(st.sampled_from([0, 1]),
                              label="promote_limit")
    port = FuzzHarness(tpool, tradix, ttiers, host_budget, promote_limit)
    ref = FuzzHarness(jpool, jradix, jtiers, host_budget, promote_limit)
    n_ops = data.draw(st.integers(5, 30), label="n_ops")
    for _ in range(n_ops):
        op = data.draw(st.sampled_from(
            ["commit", "append", "fork", "evict_base", "evict_res", "pin",
             "unpin"]), label="op")
        aid = data.draw(st.sampled_from(ADAPTERS), label="aid")
        call = None                      # (method, args) for both harnesses
        if op == "commit":
            call = ("commit", (seqs(data.draw), aid))
        elif op == "append" and port.committed:
            base, base_aid = port.committed[
                data.draw(st.integers(0, len(port.committed) - 1))]
            call = ("commit", (list(base) + seqs(data.draw), base_aid))
        elif op == "fork":
            if port.committed and data.draw(st.booleans()):
                toks, aid = port.committed[
                    data.draw(st.integers(0, len(port.committed) - 1))]
                cut = data.draw(st.integers(1, len(toks)))
                call = ("fork", (list(toks[:cut]), aid))
            else:
                call = ("fork", (seqs(data.draw) or [0] * PAGE, aid))
        elif op == "evict_base":
            n = data.draw(st.integers(1, N_PAGES))
            got = [h.dual.base.evict(n) for h in (port, ref)]
            assert got[0] == got[1]
        elif op == "evict_res":
            n = data.draw(st.integers(1, N_PAGES))
            got = [h.dual.residual.evict(n) for h in (port, ref)]
            assert got[0] == got[1]
        elif op == "pin" and port.committed and len(port.pinned) < 3:
            toks, aid = port.committed[
                data.draw(st.integers(0, len(port.committed) - 1))]
            call = ("pin", (list(toks), aid))
        elif op == "unpin" and port.pinned:
            call = ("unpin", (data.draw(st.integers(0, 7)),))
        if call is not None:
            got = [getattr(h, call[0])(*call[1]) for h in (port, ref)]
            assert got[0] == got[1], (call, got)
        for h in (port, ref):
            h.check()
        assert port.state() == ref.state()
        assert port.committed == ref.committed
    port.teardown()
    ref.teardown()
