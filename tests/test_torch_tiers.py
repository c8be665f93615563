"""Tiered KV offload in the port (port of ``tests/test_tiers.py`` and of
``tests/test_faults.py``'s tier IO fallback tests): HostTier /
TieredPagePool units, engine-level demote/promote under device-memory
pressure, and the ReAct pressure run against the reference's counters and
tokens on bridged weights.  Everything runs on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JEngine
from repro.serving.workflows import WorkflowConfig as JWorkflowConfig
from repro.serving.workflows import WorkflowDriver as JWorkflowDriver
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model
from repro_torch.core.config import ServeConfig
from repro_torch.serving.api import ForkServer, SamplingParams
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.pool import PagePool
from repro_torch.serving.radix import RadixTree
from repro_torch.serving.tiers import HostTier, TieredPagePool
from repro_torch.serving.workflows import WorkflowConfig, WorkflowDriver

PAGE = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------- HostTier
def blob(val, elems=8):
    return {"x": np.full(elems, val, np.float32)}


def test_host_tier_put_get_roundtrip_and_budget():
    host = HostTier(budget_bytes=3 * 32)      # room for three 8-float blobs
    h1 = host.put(blob(1.0))
    h2 = host.put(blob(2.0))
    assert h1 in host and host.used_bytes == 64
    np.testing.assert_array_equal(host.get(h1)["x"], blob(1.0)["x"])
    host.free(h1)
    assert h1 not in host and host.used_bytes == 32
    host.free(h1)                             # idempotent
    assert host.used_bytes == 32
    assert host.put(blob(9.0, elems=100)) is None   # larger than budget
    assert h2 in host


def test_host_tier_lru_eviction_order_and_touch():
    host = HostTier(budget_bytes=2 * 32)
    h1, h2 = host.put(blob(1.0)), host.put(blob(2.0))
    host.touch(h1)                            # h2 becomes LRU
    h3 = host.put(blob(3.0))
    assert h2 not in host and h1 in host and h3 in host
    assert host.evicted_entries == 1 and host.evicted_bytes == 32


# --------------------------------------------------- TieredPagePool + tree
class FakeDeviceStore:
    """Numpy stand-in for the executor's pooled device arrays."""

    def __init__(self, num_pages, elems=8):
        self.data = np.zeros((num_pages, elems), np.float32)

    def export(self, pages):
        return [{"x": self.data[p].copy()} for p in pages]

    def import_(self, pages, blobs):
        for p, b in zip(pages, blobs):
            self.data[p] = b["x"]


def make_tiered(num_pages=16, budget=1 << 20, promote_limit=0):
    store = FakeDeviceStore(num_pages)
    host = HostTier(budget)
    pool = TieredPagePool(PagePool(num_pages, PAGE), host,
                          export_fn=store.export, import_fn=store.import_,
                          promote_limit=promote_limit)
    tree = RadixTree(pool)
    pool.pressure_fn = tree.evict
    return tree, pool, store, host


def insert_seq(tree, pool, store, toks, fill):
    pages = pool.alloc(len(toks) // PAGE)
    for i, p in enumerate(pages):
        store.data[p] = fill * 100 + i
    tree.insert(toks, pages)
    pool.decref(pages)                        # tree becomes sole owner
    return pages


def test_demote_promote_roundtrip_bit_identical():
    tree, pool, store, host = make_tiered()
    toks = list(range(8))
    pages = insert_seq(tree, pool, store, toks, fill=7)
    snapshot = {p: store.data[p].copy() for p in pages}
    freed = tree.evict(2)
    assert freed == 2
    assert pool.used_pages == 0 and host.num_entries == 2
    assert tree.demoted_pages == 2 and tree.evicted_pages == 0
    store.data[:] = -1                        # scribble freed device memory
    got, matched, _ = tree.match_prefix(toks)
    assert matched == 8 and pool.tier_hits == 1
    for old, new in zip(pages, got):          # bytes came back exactly
        np.testing.assert_array_equal(store.data[new], snapshot[old])
        assert pool.refcount(new) == 1        # tree owns the promoted page
    assert host.num_entries == 0              # host copy consumed
    # a second demote→promote cycle still round-trips
    assert tree.evict(2) == 2
    got2, matched2, _ = tree.match_prefix(toks)
    assert matched2 == 8
    for old, new in zip(pages, got2):
        np.testing.assert_array_equal(store.data[new], snapshot[old])


def test_demote_requires_sole_ownership():
    tree, pool, store, host = make_tiered()
    toks = list(range(4))
    pages = pool.alloc(1)
    store.data[pages[0]] = 5.0
    tree.insert(toks, pages)                  # refcount 2: caller + tree
    # CoW guard → true eviction; the caller's ref keeps the page alive,
    # so ZERO pages actually become free (no phantom room reported)
    assert tree.evict(1) == 0
    assert tree.evicted_pages == 1 and tree.demoted_pages == 0
    assert host.num_entries == 0
    assert pool.refcount(pages[0]) == 1       # caller's ref survives


def test_host_budget_exhaustion_degrades_to_true_eviction():
    tree, pool, store, host = make_tiered(budget=0)
    toks = list(range(8))
    insert_seq(tree, pool, store, toks, fill=3)
    assert tree.evict(2) == 2
    assert tree.evicted_pages == 2 and tree.demoted_pages == 0
    assert pool.demote_failures > 0
    _, matched, _ = tree.match_prefix(toks)
    assert matched == 0                       # bytes are gone (seed path)
    assert pool.used_pages == 0


def test_doomed_demote_preserves_existing_host_entries():
    """A node that can NEVER fit the host budget must fail fast, not evict
    other nodes' host entries as collateral for a doomed demote."""
    tree, pool, store, host = make_tiered(budget=2 * 32)
    a = [9, 9, 9, 9, 8, 8, 8, 8]              # 2 pages: fills the budget
    insert_seq(tree, pool, store, a, fill=1)
    tree.evict(2)
    assert host.num_entries == 2
    b = list(range(12))                       # 3 pages: can never fit
    insert_seq(tree, pool, store, b, fill=2)
    tree.evict(3)                             # demote fails → true eviction
    assert tree.evicted_pages == 3 and pool.demote_failures == 1
    assert host.num_entries == 2              # a's entries survived intact
    assert tree.match_prefix(a)[1] == 8       # and still promote fine
    assert tree.match_prefix(b)[1] == 0


def test_host_lru_pressure_drops_oldest_node():
    # budget fits exactly two one-page blobs (8 floats = 32 bytes each)
    tree, pool, store, host = make_tiered(budget=2 * 32)
    a, b, c = [9, 9, 9, 9], [8, 8, 8, 8], [7, 7, 7, 7]
    insert_seq(tree, pool, store, a, fill=1)
    insert_seq(tree, pool, store, b, fill=2)
    tree.evict(2)                             # both demoted, host full
    insert_seq(tree, pool, store, c, fill=3)
    tree.evict(1)                             # demoting c evicts host-LRU a
    assert pool.host_evicted_pages == 1
    assert tree.match_prefix(a)[1] == 0       # a truly gone
    assert tree.match_prefix(b)[1] == 4       # b promoted fine
    assert tree.match_prefix(c)[1] == 4
    np.testing.assert_array_equal(store.data[tree.match_prefix(c)[0][0]],
                                  np.full(8, 300.0, np.float32))


def test_split_of_host_node_retargets_handles():
    tree, pool, store, host = make_tiered()
    toks = list(range(8))
    pages = insert_seq(tree, pool, store, toks, fill=4)
    snapshot = {p: store.data[p].copy() for p in pages}
    tree.evict(2)
    store.data[:] = -1
    got, matched, _ = tree.match_prefix(toks[:4])   # splits the host node
    assert matched == 4 and len(got) == 1
    np.testing.assert_array_equal(store.data[got[0]], snapshot[pages[0]])
    assert host.num_entries == 1              # tail half still on host
    got2, matched2, _ = tree.match_prefix(toks)
    assert matched2 == 8
    np.testing.assert_array_equal(store.data[got2[1]], snapshot[pages[1]])
    assert host.num_entries == 0


def test_promote_limit_truncates_match():
    tree, pool, store, host = make_tiered(promote_limit=1)
    insert_seq(tree, pool, store, list(range(4)), fill=1)
    insert_seq(tree, pool, store, list(range(4)) + [50, 51, 52, 53], fill=2)
    tree.evict(2)
    _, matched, _ = tree.match_prefix(list(range(4)) + [50, 51, 52, 53])
    assert matched == 4                       # second promote over budget
    assert pool.tier_hits == 1 and host.num_entries == 1
    # a fresh match gets a fresh budget and picks up the tail
    _, matched2, _ = tree.match_prefix(list(range(4)) + [50, 51, 52, 53])
    assert matched2 == 8 and host.num_entries == 0


def test_promote_limit_splits_oversized_host_node():
    """A host node LARGER than the whole per-match limit still promotes
    incrementally (split at the budget boundary), never starves."""
    tree, pool, store, host = make_tiered(promote_limit=1)
    toks = list(range(8))                     # one 2-page node
    pages = insert_seq(tree, pool, store, toks, fill=6)
    snapshot = {p: store.data[p].copy() for p in pages}
    tree.evict(2)
    store.data[:] = -1
    got, matched, _ = tree.match_prefix(toks)
    assert matched == 4 and len(got) == 1     # head promoted within budget
    np.testing.assert_array_equal(store.data[got[0]], snapshot[pages[0]])
    got2, matched2, _ = tree.match_prefix(toks)
    assert matched2 == 8                      # next match finishes the job
    np.testing.assert_array_equal(store.data[got2[1]], snapshot[pages[1]])


def test_insert_publishes_suffix_behind_demoted_prefix():
    """Commit-time insert traverses a demoted prefix position-only and
    still adopts the freshly computed suffix behind it."""
    tree, pool, store, host = make_tiered()
    s = list(range(8))
    insert_seq(tree, pool, store, s, fill=1)
    tree.evict(2)                             # prefix S now on host
    full = s + [50, 51, 52, 53]
    owned = pool.alloc(3)                     # a request recomputed S+T
    store.data[owned[2]] = 777.0
    adopted = tree.insert(full, owned)
    assert adopted == 1                       # suffix page published
    pool.decref(owned)                        # request finishes
    assert pool.refcount(owned[2]) == 1       # tree keeps the suffix
    got, matched, _ = tree.match_prefix(full)
    assert matched == 12                      # prefix promoted + suffix
    np.testing.assert_array_equal(store.data[got[2]],
                                  np.full(8, 777.0, np.float32))


def test_demote_under_full_host_with_host_ancestor_no_double_free():
    """Regression: demoting a device node that sits BELOW a host-tier node
    (insert publishes suffixes behind demoted prefixes) while the host
    budget is full must not let host-LRU eviction of the ancestor destroy
    the victim mid-demote (double decref).  The ancestor chain is pinned;
    the demote degrades to a plain eviction of the suffix only."""
    tree, pool, store, host = make_tiered(budget=2 * 32)
    s = list(range(8))
    insert_seq(tree, pool, store, s, fill=1)
    tree.evict(2)                             # prefix S on host, budget full
    full = s + [50, 51, 52, 53, 60, 61, 62, 63]
    owned = pool.alloc(4)
    tree.insert(full, owned)                  # device suffix under host node
    pool.decref(owned)
    freed = tree.evict(2)                     # must not AssertionError
    assert freed == 2 and pool.demote_failures == 1
    assert host.num_entries == 2              # ancestor's entries survived
    assert tree.match_prefix(s)[1] == 8       # prefix still promotes


def test_demote_blocked_by_pinned_entries_spares_collateral():
    """A demote that cannot complete because part of the budget is PINNED
    must fail up front — not destroy an unpinned node's entries first."""
    tree, pool, store, host = make_tiered(budget=3 * 32)
    a, c = [1, 1, 1, 1], [2, 2, 2, 2]
    insert_seq(tree, pool, store, a, fill=1)
    insert_seq(tree, pool, store, c, fill=2)
    tree.evict(2)                             # a and c on host, 32B free
    # pin c's host entry: a position-only locked match (no promotion)
    _, mc, path_c = tree.match_prefix(c, lock=True, promote=False)
    assert mc == 4 and host.num_entries == 2
    big = list(range(12))                     # 3 pages: needs 96B, but only
    insert_seq(tree, pool, store, big, fill=3)   # 32 free + 32 evictable
    assert tree.evict(3) == 3                 # demote impossible → destroy
    assert pool.demote_failures == 1
    assert host.num_entries == 2              # a survived as well as c
    tree.unlock_path(path_c)
    assert tree.match_prefix(a)[1] == 4       # a's bytes still promotable
    assert tree.match_prefix(big)[1] == 0     # big truly evicted


def test_shared_victim_with_host_children_is_skipped():
    """Eviction must not destroy a transiently shared node (refcount > 1)
    whose host-tier subtree would go with it — it skips to the next LRU
    candidate instead."""
    tree, pool, store, host = make_tiered()
    x = [1, 1, 1, 1, 2, 2, 2, 2]
    xp = insert_seq(tree, pool, store, x, fill=1)
    insert_seq(tree, pool, store, x + [3, 3, 3, 3], fill=2)
    # demote the deepest leaf so X has a host child, then share X's pages
    assert tree.evict(1) == 1 and host.num_entries == 1
    pool.incref(xp)                           # transient co-owner (running)
    y = [7, 7, 7, 7]
    insert_seq(tree, pool, store, y, fill=3)  # younger, unshared victim
    tree.match_prefix(y)                      # make X strictly LRU
    freed = tree.evict(1)
    assert freed == 1                         # Y demoted instead of X
    assert tree.match_prefix(x)[1] == 8       # X intact…
    assert host.num_entries >= 1              # …and so is its host child
    pool.decref(xp)


def test_promotion_applies_device_pressure():
    """Promoting with a full device pool demotes colder pages to make room."""
    tree, pool, store, host = make_tiered(num_pages=2)
    a, b = [1, 1, 1, 1], [2, 2, 2, 2]
    insert_seq(tree, pool, store, a, fill=1)
    insert_seq(tree, pool, store, b, fill=2)
    tree.evict(1)                             # LRU (a) demoted
    assert pool.used_pages == 1
    extra = pool.alloc(1)                     # device pool now full
    got, matched, _ = tree.match_prefix(a)    # promote a → must demote b
    assert matched == 4
    np.testing.assert_array_equal(store.data[got[0]],
                                  np.full(8, 100.0, np.float32))
    assert pool.demoted_pages == 2            # a earlier, b under pressure
    pool.decref(extra)
    _, mb, _ = tree.match_prefix(b)           # b survives on host
    assert mb == 4


# ------------------------------------------------------------ engine level
@pytest.fixture(scope="module")
def model():
    """The reference's tiny serving model (rank 8, 16 adapters) from JAX's
    init, and its bridged torch copy."""
    jcfg = jtiny(rank=8)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=16)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ((jcfg, jparams, jlora),
            (tiny_serving_model(rank=8),
             bridge.params_from_jax(np_(jparams), "cpu"),
             bridge.lora_from_jax(np_(jlora), "cpu")))


def run_one(engine, adapter, prompt, max_new=4):
    req = Request(rid=0, adapter_id=adapter, prompt=list(prompt),
                  max_new_tokens=max_new)
    engine.submit(req)
    while req.state != "done":
        engine.step()
    return req


def test_engine_demote_promote_bit_identical(model):
    """Acceptance: demoted pages promote back bit-identical through the
    real executor pools (bCache and rCache)."""
    cfg, params, lora = model[1]
    sc = ServeConfig(page_size=16, max_pages=256, max_batch=4,
                     max_prefill_tokens=64, mode="forkkv",
                     max_pages_per_req=12, host_tier_bytes=64 << 20)
    eng = Engine(cfg, params, lora, sc, device="cpu")
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(0, cfg.vocab_size, 64))
    run_one(eng, adapter=3, prompt=prompt)
    fr = eng.dual.fork(prompt, 3, lock=False)
    bpages, rpages = list(fr.base_pages), list(fr.res_pages)
    assert bpages and rpages
    pools = eng.executor.pools
    snap_kb = pools.kb[:, bpages].clone()
    snap_vb = pools.vb[:, bpages].clone()
    snap_kr = pools.kr[:, rpages].clone()
    eng.dual.base.evict(len(bpages))
    eng.dual.residual.evict(len(rpages))
    assert eng.base_pool.demoted_pages >= len(bpages)
    assert eng.res_pool.demoted_pages >= len(rpages)
    fr2 = eng.dual.fork(prompt, 3, lock=False)     # promotes both caches
    assert fr2.reuse_len >= fr.reuse_len
    b2, r2 = list(fr2.base_pages), list(fr2.res_pages)
    assert torch.equal(snap_kb, pools.kb[:, b2])
    assert torch.equal(snap_vb, pools.vb[:, b2])
    assert torch.equal(snap_kr, pools.kr[:, r2])
    m = eng.metrics()
    assert m["tier_hits"] >= 2 and m["promoted_bytes"] > 0


REACT_SC = dict(page_size=16, max_pages=26, max_batch=4,
                max_prefill_tokens=64, mode="forkkv", max_pages_per_req=24)
REACT_WF = dict(n_workflows=3, agents_per_workflow=2, rounds=2,
                shared_context_len=256, instr_len=16, tool_obs_len=24,
                max_new_tokens=4, seed=0)


def _react(model, host_tier_bytes):
    """The port's ReAct run: a device budget (26 pages) that barely covers
    ONE request's footprint, far below the working set of 6 agent contexts;
    rounds=2 makes each adapter re-fork its grown context, the reuse the
    tier preserves.  Returns (metrics report, greedy outputs by rid)."""
    cfg, params, lora = model[1]
    eng = Engine(cfg, params, lora, ServeConfig(
        **REACT_SC, host_tier_bytes=host_tier_bytes), device="cpu")
    wf = WorkflowConfig(**REACT_WF, vocab=cfg.vocab_size)
    rep = WorkflowDriver(eng, wf).run_react()
    assert eng.base_pool.free_pages + eng.base_pool.used_pages == 26
    return rep, [r.output for r in sorted(eng.done, key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def react_runs(model):
    return {on: _react(model, host_tier_bytes=(64 << 20) * on)
            for on in (False, True)}


def test_engine_tier_hits_beat_recompute_under_pressure(react_runs):
    """Acceptance: with a device page budget too small for the ReAct
    working set, the tiered engine gets tier hits instead of recomputing —
    strictly fewer prefilled tokens than the same run with the tier off."""
    off, on = react_runs[False][0], react_runs[True][0]
    assert off["tier_hits"] == 0 and off["demoted_pages"] == 0
    assert off["evicted_pages"] > 0           # pressure really happened
    assert on["tier_hits"] > 0 and on["demoted_pages"] > 0
    assert on["preemptions"] > 0              # demote-under-pressure events
    assert on["tasks_done"] == off["tasks_done"] == 12
    # base evictions truncated the off-run's reuse (partial_base); the
    # tiered run promoted those pages back instead of recomputing them
    assert off["hit_kinds"].get("partial_base", 0) > 0
    assert on["prefilled_tokens"] < off["prefilled_tokens"]
    assert on["prefill_saved_frac"] > off["prefill_saved_frac"]


TIER_KEYS = ("tier_hits", "demoted_pages", "demoted_bytes", "promoted_pages",
             "promoted_bytes", "host_evicted_pages", "dropped_device_pages",
             "host_used_bytes", "preemptions", "evicted_pages",
             "prefilled_tokens", "tasks_done", "hit_kinds")


def test_react_under_pressure_matches_reference(model, react_runs):
    """The same ReAct run with the host tier on, served by the reference
    on the same weights: the port's tier counters, prefilled tokens and
    greedy outputs are the reference's."""
    jcfg, jparams, jlora = model[0]
    eng = JEngine(jcfg, jparams, jlora, JServeConfig(
        **REACT_SC, host_tier_bytes=64 << 20))
    rep = JWorkflowDriver(eng, JWorkflowConfig(
        **REACT_WF, vocab=jcfg.vocab_size)).run_react()
    outs = [r.output for r in sorted(eng.done, key=lambda r: r.rid)]
    mine, my_outs = react_runs[True]
    assert {k: mine[k] for k in TIER_KEYS} == {k: rep[k] for k in TIER_KEYS}
    assert my_outs == outs


# ------------------------------------------------------ tier IO fallback
# (tests/test_faults.py:285-351)
def test_tier_demote_io_error_falls_back_to_eviction():
    """A failing device→host export must degrade to destroy-on-evict:
    pages reclaimed, io_error counted, no crash."""
    host = HostTier(1 << 20)
    pool = TieredPagePool(PagePool(8, 4, "base"), host)

    def boom(pages):
        raise RuntimeError("injected export failure")

    pool.bind(export_fn=boom, import_fn=lambda p, b: None)
    tree = RadixTree(pool)
    pages = pool.alloc(2)
    tree.insert([1, 2, 3, 4, 5, 6, 7, 8], pages)
    pool.decref(pages)
    freed = tree.evict(2)
    assert freed == 2
    assert pool.stats()["tier_io_errors"] == 1
    assert pool.free_pages == 8
    assert host.used_bytes == 0


def test_tier_promote_io_error_keeps_host_node():
    """A failing host→device import leaves the node a valid host-tier
    node (the match truncates; the request recomputes the suffix)."""
    host = HostTier(1 << 20)
    pool = TieredPagePool(PagePool(8, 4, "base"), host)
    calls = {"n": 0}

    def export_fn(pages):
        return [{"d": np.zeros(4)} for _ in pages]

    def import_fn(pages, blobs):
        calls["n"] += 1
        raise RuntimeError("injected import failure")

    pool.bind(export_fn=export_fn, import_fn=import_fn)
    tree = RadixTree(pool)
    pages = pool.alloc(2)
    tree.insert([1, 2, 3, 4, 5, 6, 7, 8], pages)
    pool.decref(pages)
    assert tree.evict(2) == 2                  # demoted to host
    matched_pages, matched, _ = tree.match_prefix(
        [1, 2, 3, 4, 5, 6, 7, 8])
    assert calls["n"] == 1
    assert matched_pages == [] and matched == 0   # truncated, not crashed
    assert pool.stats()["tier_io_errors"] == 1
    assert host.used_bytes > 0                 # host copy survives


def _prompt(cfg, n, seed):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, cfg.vocab_size, n)]


def test_engine_tier_fault_sites_wired(model):
    """tier_demote fires through the engine's bound export path and is
    isolated: the run completes, tier_io_errors lands in metrics."""
    cfg, params, lora = model[1]
    server = ForkServer(cfg, params, lora, ServeConfig(
        page_size=16, max_pages=10, max_batch=4, max_prefill_tokens=64,
        mode="forkkv", max_pages_per_req=12, host_tier_bytes=1 << 22,
        fault_plan="tier_demote:c1"), device="cpu")
    # distinct prompts so eviction pressure actually demotes
    for i in range(4):
        out = server.generate(
            1 + i, _prompt(cfg, 48, seed=100 + i),
            SamplingParams(max_new_tokens=4)).result()
        assert out.finish_reason == "length"
    m = server.metrics()
    assert m["faults_fired"].get("fault_tier_demote", 0) == 1
    assert m["tier_io_errors"] >= 1
