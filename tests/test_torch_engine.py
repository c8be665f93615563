"""The port's serving ``Engine`` against the JAX package's: the tests of
``tests/test_engine.py`` (modes, CoW invariants, eviction, workflows,
broadcast fork, rejection, admission control), each run on the port's
engine on the CPU, and the scenarios that shape greedy output also run
on the reference engine with the same bridged weights: greedy tokens and
step counts must be identical.

Each scenario is written once against a :class:`Side` (the engine classes
of one package and its weights), so the port and the reference run the
same code; the reference's result is computed once per module
(``jref``).  The model is a small ``tiny_serving_model`` (2 layers,
d_model 128 over 4 heads: head_dim 32, as at its defaults).
"""
import dataclasses
from typing import Any, Dict

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving import engine as jengine
from repro.serving import workflows as jworkflows
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.serving import engine as tengine
from repro_torch.serving import workflows as tworkflows

torch.set_num_threads(2)

MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)
N_ADAPTERS = 16


@dataclasses.dataclass
class Side:
    """One package's engine, request, config and workflow classes, and
    the (bridged) weights of the same model."""
    name: str
    Engine: Any
    Request: Any
    ServeConfig: Any
    workflows: Any
    cfg: Any
    params: Any
    lora: Any
    kw: Dict = dataclasses.field(default_factory=dict)

    def engine(self, mode="forkkv", max_pages=256, **extra):
        base = dict(page_size=16, max_pages=max_pages, max_batch=4,
                    max_prefill_tokens=64, mode=mode, max_pages_per_req=12)
        base.update(extra)
        return self.Engine(self.cfg, self.params, self.lora,
                           self.ServeConfig(**base), **self.kw)

    def request(self, rid, adapter, prompt, max_new, **kw):
        return self.Request(rid=rid, adapter_id=adapter,
                            prompt=[int(t) for t in prompt],
                            max_new_tokens=max_new, **kw)


@pytest.fixture(scope="module")
def sides():
    jcfg = jtiny(**MODEL)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1),
                                  n_adapters=N_ADAPTERS)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ref = Side("jax", jengine.Engine, jengine.Request, JServeConfig,
               jworkflows, jcfg, jparams, jlora)
    port = Side("torch", tengine.Engine, tengine.Request, TServeConfig,
                tworkflows, ttiny(**MODEL),
                bridge.params_from_jax(to_np(jparams), "cpu"),
                bridge.lora_from_jax(to_np(jlora), "cpu"),
                kw=dict(device="cpu"))
    return ref, port


@pytest.fixture(scope="module")
def jref(sides):
    """The reference's result of a scenario, computed once per module."""
    cache = {}

    def get(scenario):
        if scenario not in cache:
            cache[scenario] = SCENARIOS[scenario](sides[0])
        return cache[scenario]

    return get


def run_one(eng, side, adapter, prompt, max_new=6):
    req = side.request(0, adapter, prompt, max_new)
    eng.submit(req)
    while req.state != "done":
        eng.step()
    return req


def tokens(req):
    return [int(t) for t in req.output]


# ------------------------------------------------------------- scenarios
def single_request(side):
    eng = side.engine("forkkv")
    prompt = np.random.default_rng(0).integers(0, side.cfg.vocab_size, 40)
    req = run_one(eng, side, 1, prompt)
    return dict(outputs=[tokens(req)], steps=eng.steps)


def cross_adapter(side):
    eng = side.engine("forkkv")
    rng = np.random.default_rng(0)
    v = side.cfg.vocab_size
    shared = list(rng.integers(0, v, 64))
    r1 = run_one(eng, side, 0, shared + list(rng.integers(0, v, 8)))
    base1, res1 = eng.base_pool.used_pages, eng.res_pool.used_pages
    r2 = run_one(eng, side, 1, shared + list(rng.integers(0, v, 8)))
    return dict(outputs=[tokens(r1), tokens(r2)], steps=eng.steps,
                hit_kinds=dict(eng.dual.hit_kinds),
                base_growth=eng.base_pool.used_pages - base1,
                res_growth=eng.res_pool.used_pages - res1)


def full_hit(side):
    eng = side.engine("forkkv")
    shared = list(np.random.default_rng(0).integers(0, side.cfg.vocab_size,
                                                    64))
    r1 = run_one(eng, side, 2, shared)
    r2 = run_one(eng, side, 2, shared)
    return dict(outputs=[tokens(r1), tokens(r2)], steps=eng.steps,
                hit_kinds=dict(eng.dual.hit_kinds),
                prefilled=[r1.prefilled_tokens, r2.prefilled_tokens])


def two_adapters(mode):
    def scenario(side):
        eng = side.engine(mode)
        shared = list(np.random.default_rng(0).integers(
            0, side.cfg.vocab_size, 64))
        r1 = run_one(eng, side, 0, shared)
        before = eng.base_pool.used_pages
        r2 = run_one(eng, side, 7 if mode == "full_reuse" else 1, shared)
        return dict(outputs=[tokens(r1), tokens(r2)], steps=eng.steps,
                    growth=eng.base_pool.used_pages - before,
                    hit_rate=eng.metrics()["hit_rate"])
    return scenario


def eviction(side):
    eng = side.engine("forkkv", max_pages=16)
    rng = np.random.default_rng(0)
    v = side.cfg.vocab_size
    shared = list(rng.integers(0, v, 48))
    outs = [tokens(run_one(eng, side, a,
                           shared + list(rng.integers(0, v, 32)), max_new=4))
            for a in range(6)]
    m = eng.metrics()
    return dict(outputs=outs, steps=eng.steps, tasks_done=m["tasks_done"],
                evicted_pages=m["evicted_pages"],
                pages=eng.base_pool.free_pages + eng.base_pool.used_pages)


def broadcast(side):
    eng = side.engine("forkkv", max_batch=6, broadcast_fork=True)
    shared = list(np.random.default_rng(0).integers(0, side.cfg.vocab_size,
                                                    64))
    reqs = [side.request(i, i, shared, 4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    while any(r.state != "done" for r in reqs):
        eng.step()
    return dict(outputs=[tokens(r) for r in reqs], steps=eng.steps,
                prefilled=[r.prefilled_tokens for r in reqs],
                pages=eng.base_pool.free_pages + eng.base_pool.used_pages)


def overlong(side):
    eng = side.engine("forkkv")           # max_pages_per_req 12: 192 tokens
    rng = np.random.default_rng(0)
    v = side.cfg.vocab_size
    too_long = side.request(1, 0, rng.integers(0, v, 400), 4)
    ok = side.request(2, 1, rng.integers(0, v, 40), 4)
    eng.submit(too_long)
    eng.submit(ok)
    eng.run()
    m = eng.metrics()
    return dict(outputs=[tokens(too_long), tokens(ok)], steps=eng.steps,
                states=[too_long.state, ok.state],
                errors=[too_long.error, ok.error], rejected=m["rejected"],
                tasks_done=m["tasks_done"])


def shedding(side):
    eng = side.engine("forkkv", max_batch=1, max_queue_depth=2)
    rng = np.random.default_rng(1)
    reqs = [side.request(i, 0, rng.integers(0, side.cfg.vocab_size, 40), 2)
            for i in range(1, 7)]
    for i, r in enumerate(reqs):
        eng.submit(r)
        r.arrival = float(i)        # explicit arrival order (no clock ties)
    eng.step()
    shed = sorted(r.rid for r in reqs if r.finish_reason == "rejected")
    survivors = sorted({r.rid for r in eng.running} |
                       {r.rid for r in eng.waiting})
    retry = [r.retry_after_s for r in reqs if r.finish_reason == "rejected"]
    errors = [r.error for r in reqs if r.finish_reason == "rejected"]
    counts = (eng.shed, eng.rejected)
    while any(r.state != "done" for r in reqs):
        eng.step()
    return dict(outputs=[tokens(r) for r in reqs], steps=eng.steps,
                shed=shed, survivors=survivors, retry=retry, errors=errors,
                counts=counts, reasons=[r.finish_reason for r in reqs],
                metric_shed=eng.metrics()["shed"])


SCENARIOS = {"single": single_request, "cross_adapter": cross_adapter,
             "full_hit": full_hit, "prefix": two_adapters("prefix"),
             "full_reuse": two_adapters("full_reuse"), "eviction": eviction,
             "broadcast": broadcast, "overlong": overlong,
             "shedding": shedding}


def same_as_reference(got, jref, scenario):
    """Greedy tokens and step counts equal the reference's."""
    want = jref(scenario)
    assert got["outputs"] == want["outputs"], scenario
    assert got["steps"] == want["steps"], scenario


# ----------------------------------------------------------------- tests
def test_single_request_generates(sides, jref):
    got = single_request(sides[1])
    out = got["outputs"][0]
    assert len(out) == 7                 # max_new + the final unconsumed
    assert all(0 <= t < sides[1].cfg.vocab_size for t in out)
    same_as_reference(got, jref, "single")


def test_forkkv_base_cache_shared_across_adapters(sides, jref):
    got = cross_adapter(sides[1])
    assert got["hit_kinds"].get("partial_res", 0) >= 1
    assert got["base_growth"] < got["res_growth"], got
    same_as_reference(got, jref, "cross_adapter")
    want = jref("cross_adapter")
    assert (got["hit_kinds"], got["base_growth"], got["res_growth"]) == \
        (want["hit_kinds"], want["base_growth"], want["res_growth"])


def test_forkkv_same_agent_full_hit_skips_prefill(sides, jref):
    got = full_hit(sides[1])
    assert got["hit_kinds"].get("full", 0) >= 1
    assert got["prefilled"][1] < got["prefilled"][0]
    same_as_reference(got, jref, "full_hit")
    assert got["prefilled"] == jref("full_hit")["prefilled"]


def test_prefix_mode_no_cross_adapter_sharing(sides, jref):
    got = SCENARIOS["prefix"](sides[1])
    assert got["growth"] >= 64 // 16          # full duplicate cache
    assert got["hit_rate"] == 0.0
    same_as_reference(got, jref, "prefix")


def test_cow_shared_pages_not_written(sides):
    """CoW invariant: after a second agent forks, the first agent's cached
    base pages must be byte-identical (read-only parent pages)."""
    side = sides[1]
    eng = side.engine("forkkv")
    shared = list(np.random.default_rng(0).integers(0, side.cfg.vocab_size,
                                                    64))
    run_one(eng, side, 0, shared)
    fr = eng.dual.fork([int(t) for t in shared], 99, lock=False)
    pages = list(fr.base_pages)
    snapshot = eng.executor.pools.kb[:, pages].clone()
    run_one(eng, side, 1, shared + [5, 6, 7])
    assert torch.equal(snapshot, eng.executor.pools.kb[:, pages])


def test_eviction_under_pressure_and_partial_hit(sides, jref):
    got = eviction(sides[1])
    assert got["tasks_done"] == 6
    assert got["evicted_pages"] > 0      # 16 pages: evictions must happen
    assert got["pages"] == 16
    same_as_reference(got, jref, "eviction")
    assert got["evicted_pages"] == jref("eviction")["evicted_pages"]


def test_full_reuse_shares_everything(sides, jref):
    got = SCENARIOS["full_reuse"](sides[1])
    assert got["growth"] <= 2
    same_as_reference(got, jref, "full_reuse")


def test_memory_ordering_forkkv_beats_prefix(sides):
    """The paper's core claim at engine level: with N agents over one
    shared context, ForkKV peak memory << prefix caching peak memory."""
    side = sides[1]
    rng = np.random.default_rng(0)
    v = side.cfg.vocab_size
    shared = list(rng.integers(0, v, 96))
    peaks = {}
    for mode in ("forkkv", "prefix"):
        eng = side.engine(mode, max_pages=512)
        for a in range(4):
            run_one(eng, side, a, shared + list(rng.integers(0, v, 8)),
                    max_new=4)
        peaks[mode] = eng.metrics()["peak_cache_bytes"]
    assert peaks["forkkv"] < peaks["prefix"]


def test_mapreduce_workflow_runs(sides):
    side = sides[1]
    eng = side.engine("forkkv", max_pages=512)
    wf = side.workflows.WorkflowConfig(
        n_workflows=1, agents_per_workflow=3, shared_context_len=64,
        max_new_tokens=4, vocab=side.cfg.vocab_size)
    rep = side.workflows.WorkflowDriver(eng, wf).run_mapreduce()
    assert rep["tasks"] == 4
    assert rep["tasks_done"] == 4


def test_broadcast_fork(sides, jref):
    """Broadcast fork: N simultaneous agents over one context prefill it
    ONCE (amortized), outputs stay finite, pages consistent."""
    got = broadcast(sides[1])
    assert sum(got["prefilled"]) < 2.0 * 64, got["prefilled"]
    assert all(len(o) == 5 for o in got["outputs"])
    assert got["pages"] == 256
    same_as_reference(got, jref, "broadcast")
    assert got["prefilled"] == jref("broadcast")["prefilled"]


def test_overlong_request_rejected_gracefully(sides, jref):
    """An over-long request is rejected (state=done with an error note)
    instead of raising from inside the admit loop, and the engine keeps
    serving the rest of the queue."""
    got = overlong(sides[1])
    assert got["states"] == ["done", "done"]
    assert "rejected" in got["errors"][0] and got["outputs"][0] == []
    assert got["errors"][1] == "" and len(got["outputs"][1]) == 5
    assert got["rejected"] == 1 and got["tasks_done"] == 2
    same_as_reference(got, jref, "overlong")


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # minimal env: keep deterministic tests running
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @settings(max_examples=4, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 3),       # adapter id
                              st.integers(2, 5),       # shared-prefix pages
                              st.integers(0, 24),      # extra prompt tokens
                              st.integers(1, 4)),      # max_new
                    min_size=1, max_size=5),
           st.sampled_from(["forkkv", "prefix", "full_reuse"]))
    def test_property_engine_invariants(sides, reqs_spec, mode):
        """Any workload, any mode: every request completes with the right
        output length; page pools conserve pages."""
        side = sides[1]
        eng = side.engine(mode, max_pages=96, max_pages_per_req=10)
        rng = np.random.default_rng(0)
        v = side.cfg.vocab_size
        shared = list(rng.integers(0, v, 48))
        reqs = [side.request(i, aid, shared + list(rng.integers(0, v, extra)),
                             max_new)
                for i, (aid, _, extra, max_new) in enumerate(reqs_spec)]
        for r in reqs:
            eng.submit(r)
        for _ in range(5000):
            if not eng.waiting and not eng.running:
                break
            eng.step()
        for r in reqs:
            assert r.state == "done"
            assert len(r.output) == r.max_new_tokens + 1
            assert all(0 <= t < v for t in r.output)
        assert eng.base_pool.free_pages + eng.base_pool.used_pages == 96
        assert eng.res_pool.free_pages + eng.res_pool.used_pages == \
            eng.res_pool.num_pages
else:
    def test_property_engine_skipped_without_hypothesis():
        pytest.importorskip("hypothesis")


# ------------------------------------------------ admission control (§15)
def test_deadline_times_out_waiting_request(sides):
    """A request still waiting past its deadline finishes with
    finish_reason="timeout"; admitted work is untouched."""
    side = sides[1]
    eng = side.engine("forkkv", max_batch=1)
    rng = np.random.default_rng(0)
    v = side.cfg.vocab_size
    a = side.request(1, 0, rng.integers(0, v, 40), 4)
    b = side.request(2, 1, rng.integers(0, v, 40), 4, deadline_s=0.5)
    eng.submit(a)
    eng.submit(b)
    eng.step()                      # admits a (batch slot 1 of 1)
    assert a in eng.running and b in eng.waiting
    b.arrival -= 1.0                # age b past its 0.5s deadline
    eng.step()
    assert b.state == "done" and b.finish_reason == "timeout"
    assert b.error.startswith("timeout") and eng.timeouts == 1
    while a.state != "done":
        eng.step()
    assert a.finish_reason == "length"
    m = eng.metrics()
    assert m["timeouts"] == 1 and m["tenants"]["default"]["timeouts"] == 1


def test_shedding_fires_deterministically_at_queue_bound(sides, jref):
    """Overload: with max_queue_depth=2, a burst of 6 sheds exactly the
    newest arrivals beyond the bound — same queue, same victims."""
    got = shedding(sides[1])
    assert got["shed"] == [3, 4, 5, 6]
    assert got["counts"] == (4, 4)
    assert all(r >= 1.0 for r in got["retry"])
    assert all("overloaded" in e for e in got["errors"])
    assert got["survivors"] == [1, 2]
    assert got["reasons"][:2] == ["length", "length"]
    assert got["metric_shed"] == 4
    same_as_reference(got, jref, "shedding")


def test_fairshare_light_tenant_admission_not_starved(sides):
    """A hog burst must not starve a light tenant under fair share: WFQ
    admits the light request within the first batch, while FIFO makes it
    wait for the whole hog backlog."""
    side = sides[1]
    waits = {}
    for admission in ("fifo", "fairshare"):
        eng = side.engine("forkkv", max_batch=2, admission=admission)
        rng = np.random.default_rng(2)
        v = side.cfg.vocab_size
        hogs = [side.request(i, 0, rng.integers(0, v, 40), 2, tenant="hog")
                for i in range(1, 7)]
        light = side.request(9, 1, rng.integers(0, v, 40), 2,
                             tenant="light")
        for r in hogs + [light]:    # submission order: hogs, then light
            eng.submit(r)
        while any(r.state != "done" for r in hogs + [light]):
            eng.step()
        waits[admission] = sum(1 for r in hogs
                               if r.admitted_at < light.admitted_at)
        snap = eng.metrics()["tenants"]
        assert snap["light"]["accepted"] == 1
        assert snap["hog"]["accepted"] == 6
    assert waits["fifo"] == 6
    assert waits["fairshare"] <= 1
