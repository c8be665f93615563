"""Fault-tolerant serving gates (DESIGN.md §17) on the port, against the
JAX package: the ``tests/test_faults.py`` tests not ported elsewhere —
preempt–restore parity (forced and under real pressure), quarantine of
one row, engine drain, executor isolation, the stuck-pump watchdog over
the port's HTTP front end, and the fault-plan grammar.  (The HTTP drain
and client-retry tests are in ``test_torch_frontend.py``, the
phase-separated quarantine in ``test_torch_serving.py``, the tier IO
fallbacks in ``test_torch_tiers.py``.)

The port serves on the CPU with weights bridged from the reference's.
Where a fault changes the schedule (preempt–restore, quarantine), the
same fault plan also runs on the reference's ``ForkServer``: greedy
tokens, step counts and the fault counters must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving.api import ForkServer as JForkServer
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.serving.api import ForkServer as TForkServer
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.frontend import ForkClient, HttpFrontend
from repro_torch.serving.sampling import SamplingParams

torch.set_num_threads(2)

MODES = ["forkkv", "prefix", "full_reuse"]
MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)


@pytest.fixture(scope="module")
def model():
    jcfg = jtiny(**MODEL)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=16)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jax=(jcfg, jparams, jlora),
                torch=(ttiny(**MODEL),
                       bridge.params_from_jax(to_np(jparams), "cpu"),
                       bridge.lora_from_jax(to_np(jlora), "cpu")))


def make_server(model, side="torch", **kw):
    cfg, params, lora = model[side]
    base = dict(page_size=16, max_pages=256, max_batch=4,
                max_prefill_tokens=64, mode="forkkv", max_pages_per_req=12)
    base.update(kw)
    if side == "jax":
        return JForkServer(cfg, params, lora, JServeConfig(**base)), cfg
    return TForkServer(cfg, params, lora, TServeConfig(**base),
                       device="cpu"), cfg


def prompt_tokens(cfg, n, seed=0):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, cfg.vocab_size, n)]


def serve(server, sp_cls, requests):
    """(tokens, finish reasons, errors, metrics) of ``requests``
    ((adapter, prompt, max_new) each) submitted together."""
    outs = server.wait([server.generate(a, p, sp_cls(max_new_tokens=n))
                        for a, p, n in requests])
    return ([[int(t) for t in o.tokens] for o in outs],
            [o.finish_reason for o in outs], [o.error for o in outs],
            server.metrics())


# ---------------------------------------------------------------- parity
def preempt_plan(mode):
    """The reference test's plan: forkkv admission allocates from both
    pools (base then residual); fail the 8 pool_alloc calls after the
    first request's so the second stays blocked past
    preempt_after_steps."""
    pre = 2 if mode == "forkkv" else 1
    return "pool_alloc:" + ",".join(f"c{pre + i + 1}" for i in range(8))


@pytest.mark.parametrize("mode", MODES)
def test_preempt_restore_token_parity(model, mode):
    """A seeded fault plan denies the second request's page allocations
    until the preempt trigger fires, checkpointing the first request into
    the radix tree mid-decode; once restored, its greedy tokens equal an
    undisturbed run's.  In forkkv the faulted run also matches the
    reference's under the same plan: tokens, steps, preemptions."""
    cfg = model["torch"][0]
    reqs = [(1, prompt_tokens(cfg, 40, seed=21), 16),
            (2, prompt_tokens(cfg, 40, seed=22), 8)]
    undisturbed, _ = make_server(model, mode=mode)
    ref, _, _, _ = serve(undisturbed, SamplingParams, reqs)

    kw = dict(mode=mode, fault_plan=preempt_plan(mode), preempt_after_steps=2)
    server, _ = make_server(model, **kw)
    toks, reasons, _, m = serve(server, SamplingParams, reqs)
    assert m["preempted_requests"] >= 1, m["faults_fired"]
    assert m["restored_requests"] >= 1
    assert m["faults_fired"]["fault_pool_alloc"] >= 2
    assert reasons == ["length", "length"]
    assert toks[0] == ref[0], "victim tokens diverged after restore"
    assert toks[1] == ref[1]
    assert m["fallback_gather_calls"] == 0
    if mode == "forkkv":
        jserver, _ = make_server(model, "jax", **kw)
        jtoks, _, _, jm = serve(jserver, JSamplingParams, reqs)
        assert toks == jtoks
        for key in ("steps", "preempted_requests", "restored_requests",
                    "recompute_tokens", "faults_fired"):
            assert m[key] == jm[key], key


def test_preempt_restore_under_real_pressure(model):
    """Without injection: a pool too small for both requests forces a
    real preemption; tokens equal the undisturbed run's, and tokens,
    steps and preemption counters equal the reference's."""
    cfg = model["torch"][0]
    reqs = [(1, prompt_tokens(cfg, 40, seed=31), 24),
            (2, prompt_tokens(cfg, 40, seed=32), 8)]
    undisturbed, _ = make_server(model, mode="forkkv")
    ref, _, _, _ = serve(undisturbed, SamplingParams, reqs)
    # 7 pages total - 1 dump: r1 takes 4 (40+24 tokens), leaving 2 < the
    # 3 r2 needs -> r2 blocks, preempt trigger fires
    kw = dict(mode="forkkv", max_pages=7, preempt_after_steps=1)
    server, _ = make_server(model, **kw)
    toks, _, _, m = serve(server, SamplingParams, reqs)
    assert m["preempted_requests"] >= 1
    assert m["restored_requests"] >= 1
    assert toks == ref
    assert m["fallback_gather_calls"] == 0
    jserver, _ = make_server(model, "jax", **kw)
    jtoks, _, _, jm = serve(jserver, JSamplingParams, reqs)
    assert toks == jtoks
    for key in ("steps", "preempted_requests", "restored_requests",
                "recompute_tokens"):
        assert m[key] == jm[key], key


# ------------------------------------------------------------ quarantine
def test_quarantine_isolates_one_row(model):
    """An injected NaN on one request in a mixed batch: that request alone
    finishes ``finish_reason="error"``; its co-batched peers finish with
    undisturbed tokens (and the reference's under the same plan); every
    page is reclaimed afterwards."""
    cfg = model["torch"][0]
    reqs = [(1 + i, prompt_tokens(cfg, 36 + 2 * i, seed=40 + i), 6)
            for i in range(3)]
    undisturbed, _ = make_server(model)
    ref, _, _, _ = serve(undisturbed, SamplingParams, reqs)

    # rids are assigned 1.. in generate() order: poison request 2 only
    server, _ = make_server(model, fault_plan="nan_logits:r2")
    toks, reasons, errors, m = serve(server, SamplingParams, reqs)
    assert reasons[1] == "error" and "quarantined" in errors[1]
    assert reasons[0] == "length" and toks[0] == ref[0]
    assert reasons[2] == "length" and toks[2] == ref[2]
    assert m["quarantined"] == 1
    assert m["fallback_gather_calls"] == 0
    jserver, _ = make_server(model, "jax", fault_plan="nan_logits:r2")
    jtoks, jreasons, _, jm = serve(jserver, JSamplingParams, reqs)
    assert (toks, reasons, m["steps"]) == (jtoks, jreasons, jm["steps"])

    eng = server.engine
    eng.dual.base.evict(eng.sc.max_pages)
    eng.dual.residual.evict(eng.res_pool.num_pages)
    assert eng.base_pool.free_pages == eng.sc.max_pages - 1
    assert eng.res_pool.free_pages == eng.res_pool.num_pages - 1


# ----------------------------------------------------------------- drain
def test_engine_drain_refuses_queued_finishes_inflight(model):
    cfg = model["torch"][0]
    server, _ = make_server(model, max_batch=1)
    h1 = server.generate(1, prompt_tokens(cfg, 40, seed=61),
                         SamplingParams(max_new_tokens=6))
    server.poll()                  # admit + start h1 (batch slot 1)
    h2 = server.generate(2, prompt_tokens(cfg, 40, seed=62),
                         SamplingParams(max_new_tokens=6))
    server.drain()
    outs = server.wait([h1, h2])
    assert outs[0].finish_reason == "length" and len(outs[0].tokens) == 6
    assert outs[1].finish_reason == "draining"
    assert server.drained
    m = server.metrics()
    assert m["draining"] and m["drained"]


# ---------------------------------------------------- executor isolation
def test_executor_exception_fails_batch_not_pump(model):
    cfg = model["torch"][0]
    server, _ = make_server(model, fault_plan="executor:c3")
    out1 = server.generate(1, prompt_tokens(cfg, 40, seed=91),
                           SamplingParams(max_new_tokens=12)).result()
    assert out1.finish_reason == "error"
    assert "injected fault" in out1.error
    # the pump survives: a fresh request completes normally
    out2 = server.generate(2, prompt_tokens(cfg, 40, seed=92),
                           SamplingParams(max_new_tokens=4)).result()
    assert out2.finish_reason == "length" and len(out2.tokens) == 4
    m = server.metrics()
    assert m["exec_errors"] == 1
    assert m["faults_fired"]["fault_executor"] == 1


# -------------------------------------------------------------- watchdog
def test_watchdog_trips_on_injected_stall(model):
    server, cfg = make_server(model, fault_plan="pump_stall:c2,c3",
                              watchdog_s=0.05)
    server.engine.faults.stall_s = 0.3
    fe = HttpFrontend(server).start_background()
    client = ForkClient(port=fe.port)
    try:
        doc = client.completion(prompt_tokens(cfg, 40, seed=111),
                                max_new_tokens=8)
        assert len(doc["tokens"]) == 8       # stall delays, never corrupts
        assert client.metrics()["watchdog_trips"] >= 1
        assert client.healthz()              # recovered: healthy again
    finally:
        fe.shutdown()


def test_fault_plan_grammar():
    fi = FaultInjector("pool_alloc:c2,c4;nan_logits:r9;executor:*", seed=1)
    assert fi.active
    assert [fi.fire("pool_alloc") for _ in range(5)] == \
        [False, True, False, True, False]
    assert not fi.fire("nan_logits", key=8)
    assert fi.fire("nan_logits", key=9)
    assert fi.fire("executor") and fi.fire("executor")
    assert fi.stats() == {"fault_pool_alloc": 2, "fault_nan_logits": 1,
                          "fault_executor": 2}
    with pytest.raises(ValueError):
        FaultInjector("bogus_site:c1")
    with pytest.raises(ValueError):
        FaultInjector("pool_alloc:x9").fire("pool_alloc")
    # probabilistic triggers are seed-deterministic
    a = [FaultInjector("pool_alloc:p0.5", seed=3).fire("pool_alloc")
         for _ in range(1)]
    b = [FaultInjector("pool_alloc:p0.5", seed=3).fire("pool_alloc")
         for _ in range(1)]
    assert a == b
