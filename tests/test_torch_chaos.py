"""Chaos schedules (DESIGN.md §17) on the port: the tests of
``tests/test_chaos.py`` — fault plans over fork/append/preempt/restore/
quarantine/drain interleavings against a real small engine.

Whatever faults fire and wherever a drain cuts in:

* every submitted request reaches a terminal ``finish_reason``;
* once drained (and the trees let go) both device pools reclaim every
  page but the reserved dump page;
* a non-injected co-request finishes with a scheduler reason, never a
  crash, and each executor failure is an injected one
  (``exec_errors == faults_fired["fault_executor"]``);
* the counters move only when their fault fired.

The port serves on the CPU with weights bridged from the reference's.
The three deterministic schedules also run on the reference's
``ForkServer`` (computed once per module): finish reasons, greedy tokens,
step and poll counts and the fault counters must be identical.

The port's loop calls ``drain()`` once ``drain_after`` polls have passed
*or* the queue has quiesced, whichever comes first, so a drawn drain is
always reached; the reference's loop (``tests/test_chaos.py:67-72``) can
quiesce first and then fails ``assert eng.drained``.  The draw recorded for
that (``test_quiesce_before_drain_draw_on_both_engines``) is kept as an
explicit case on both engines.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving.api import ForkServer as JForkServer
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.serving.api import ForkServer as TForkServer
from repro_torch.serving.sampling import SamplingParams as TSamplingParams

torch.set_num_threads(2)

MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)
TERMINAL = {"stop", "length", "rejected", "stalled", "timeout", "error",
            "draining"}
COUNTERS = ("exec_errors", "quarantined", "faults_fired",
            "preempted_requests", "restored_requests", "steps", "draining",
            "drained")
# (plan, seed, request specs (prompt length, max_new, adapter),
# drain_after, max_pages) of tests/test_chaos.py:105-130
SCHEDULES = {
    "preempt_quarantine": ("nan_logits:r3", 5,
                           [(40, 12, 1), (40, 6, 2), (36, 6, 3), (38, 6, 4)],
                           None, 10),
    "drain_mid_flight": ("", 6, [(40, 10, 1), (40, 10, 2), (40, 10, 3)], 2,
                         10),
    "executor_storm": ("executor:c2,c5;pool_alloc:c5,c6", 7,
                       [(40, 8, 1), (38, 8, 2), (36, 8, 3)], None, 12),
    # a fuzz draw on which the reference's loop quiesces before drain()
    "quiesce_before_drain": ("pool_alloc:c12;nan_logits:c1;executor:c1,c1",
                             0, [(32, 4, 1), (32, 4, 2), (32, 4, 3)], 6, 9),
}


@pytest.fixture(scope="module")
def model():
    jcfg = jtiny(**MODEL)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=16)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jax=(JForkServer, JServeConfig, JSamplingParams, jcfg,
                     jparams, jlora, {}),
                torch=(TForkServer, TServeConfig, TSamplingParams,
                       ttiny(**MODEL),
                       bridge.params_from_jax(to_np(jparams), "cpu"),
                       bridge.lora_from_jax(to_np(jlora), "cpu"),
                       dict(device="cpu")))


@pytest.fixture(scope="module")
def jref(model):
    """The reference's run of a schedule, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_schedule(model["jax"], *SCHEDULES[name],
                                       drain_on_quiesce=False)
        return cache[name]

    return get


def run_schedule(side, plan, seed, req_specs, drain_after, max_pages=12,
                 drain_on_quiesce=True):
    """Drive one fault schedule to quiescence and check the invariants.

    ``drain_after``: the poll count at which drain() is called (None:
    never); with ``drain_on_quiesce`` (the port's loop) drain() is also
    called as soon as nothing is waiting or running, if it was not called
    yet.  A small pool and ``preempt_after_steps=1`` keep preempt–restore
    in play on most schedules.  Returns what the engines must agree on."""
    ForkServer, ServeConfig, SamplingParams, cfg, params, lora, kw = side
    sc = ServeConfig(page_size=16, max_pages=max_pages, max_batch=4,
                     max_prefill_tokens=64, mode="forkkv",
                     max_pages_per_req=8, preempt_after_steps=1,
                     fault_plan=plan, fault_seed=seed)
    server = ForkServer(cfg, params, lora, sc, **kw)
    eng = server.engine
    rng = np.random.default_rng(seed)
    handles = []
    for plen, max_new, aid in req_specs:
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, plen)]
        handles.append(server.generate(
            aid, prompt, SamplingParams(max_new_tokens=max_new)))
    polls, drained_at = 0, None
    while True:
        quiet = not (eng.waiting or eng.running)
        if drain_after is not None and drained_at is None and (
                polls == drain_after or (quiet and drain_on_quiesce)):
            server.drain()
            drained_at = polls
        if quiet:
            break
        server.poll()
        polls += 1
        assert polls < 2000, "schedule failed to quiesce"

    outs = [h.result() for h in handles]
    # 1. every request reached a terminal state
    for out in outs:
        assert out.finish_reason in TERMINAL, out.finish_reason
        if out.finish_reason == "error":
            assert out.error, "error finish without a reason string"
    if drained_at is not None:
        assert eng.drained

    # 2. zero page leaks once the trees let go (the dump page stays)
    eng.dual.base.evict(eng.sc.max_pages)
    eng.dual.residual.evict(eng.res_pool.num_pages)
    assert eng.base_pool.free_pages == eng.sc.max_pages - 1, \
        "base pool leaked pages"
    assert eng.res_pool.free_pages == eng.res_pool.num_pages - 1, \
        "residual pool leaked pages"

    # 3. counters move only when their fault fired
    m = server.metrics()
    fired = m["faults_fired"]
    if m["quarantined"]:
        assert fired.get("fault_nan_logits", 0) >= 1
    assert m["exec_errors"] == fired.get("fault_executor", 0)
    assert m["restored_requests"] <= m["preempted_requests"]
    assert m["fallback_gather_calls"] == 0
    return dict(reasons=[o.finish_reason for o in outs],
                tokens=[[int(t) for t in o.tokens] for o in outs],
                errors=[o.error for o in outs], polls=polls,
                drained_at=drained_at, **{k: m[k] for k in COUNTERS})


def same_as_reference(got, want):
    """Everything but the drain, which only the port's loop may call
    at quiescence."""
    skip = ("drained_at", "draining", "drained")
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}


# ------------------------------------------------- deterministic schedules
def test_chaos_deterministic_preempt_and_quarantine(model, jref):
    """One fixed schedule exercising preempt + quarantine in a single run."""
    got = run_schedule(model["torch"], *SCHEDULES["preempt_quarantine"])
    assert got["quarantined"] == 1
    assert got == jref("preempt_quarantine")


def test_chaos_deterministic_drain_mid_flight(model, jref):
    got = run_schedule(model["torch"], *SCHEDULES["drain_mid_flight"])
    assert got["draining"] and got["drained"]
    assert got["drained_at"] == 2
    assert got == jref("drain_mid_flight")


def test_chaos_deterministic_executor_storm(model, jref):
    got = run_schedule(model["torch"], *SCHEDULES["executor_storm"])
    assert got["exec_errors"] >= 1
    assert got == jref("executor_storm")


def test_quiesce_before_drain_draw_on_both_engines(model, jref):
    """The fuzz draw plan ``pool_alloc:c12;nan_logits:c1;executor:c1,c1``,
    seed 0, three requests of (32, 4), ``drain_after=6``, 9 pages: both
    engines quiesce after the same 2 polls in the same state (one
    quarantined row, one isolated executor failure), so neither livelocks.
    The reference's loop never reaches drain() there; the port's loop
    drains at quiescence, and the drained engine holds nothing."""
    got = run_schedule(model["torch"], *SCHEDULES["quiesce_before_drain"])
    want = jref("quiesce_before_drain")
    assert want["polls"] == got["polls"] == 2 < 6
    assert want["drained_at"] is None and not want["draining"]
    assert got["drained_at"] == 2 and got["drained"]
    same_as_reference(got, want)


# ------------------------------------------------------------------- fuzz
sites = st.sampled_from(["pool_alloc", "nan_logits", "executor"])


@st.composite
def plans(draw):
    """0–3 fault rules with early-ish cN triggers (late triggers never
    fire on short schedules) and the occasional rN poisoning a specific
    request."""
    rules = []
    for site in draw(st.lists(sites, max_size=3, unique=True)):
        trigs = draw(st.lists(st.integers(1, 15).map(lambda n: f"c{n}"),
                              min_size=1, max_size=2))
        if site == "nan_logits" and draw(st.booleans()):
            trigs = [f"r{draw(st.integers(1, 4))}"]
        rules.append(f"{site}:{','.join(trigs)}")
    return ";".join(rules)


@settings(max_examples=8, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(data=st.data())
def test_chaos_fault_schedule_fuzz(model, data):
    plan = data.draw(plans(), label="plan")
    seed = data.draw(st.integers(0, 99), label="seed")
    n_req = data.draw(st.integers(2, 4), label="n_req")
    req_specs = [
        (data.draw(st.sampled_from([32, 36, 40]), label=f"plen{i}"),
         data.draw(st.sampled_from([4, 6, 10]), label=f"new{i}"), 1 + i)
        for i in range(n_req)]
    drain_after = data.draw(st.one_of(st.none(), st.integers(0, 6)),
                            label="drain_after")
    max_pages = data.draw(st.sampled_from([9, 12, 16]), label="max_pages")
    run_schedule(model["torch"], plan, seed, req_specs, drain_after,
                 max_pages=max_pages)
