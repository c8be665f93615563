"""The port's iteration-level scheduler (``repro_torch.serving.scheduler``,
DESIGN.md §14) against the JAX package's: the tests of
``tests/test_scheduler.py`` — the planner's invariants, the unified grid's
oracle checks of #1 and #3, and the stall detector under mixed batching.

* Planner: every plan the port makes equals the reference's on the same
  running set (each row's request, kind, start and q_len; the budget).
* Oracle: the port's mixed entries (``kernels/ops.py``, which the
  executor calls) on CPU tensors, that is their plain versions,
  equal ``repro.kernels.ref``'s mixed oracle on the same numpy-seeded
  inputs, with exact zeros past each row's q_len.
* Stall: the port's engine on weights bridged from the reference's fails
  the request that can never allocate after ``stall_limit`` empty plans,
  in the same step as the reference's engine.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.serving import engine as jengine
from repro.serving import scheduler as jscheduler
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.kernels import ops
from repro_torch.serving import engine as tengine
from repro_torch.serving import scheduler as tscheduler

torch.set_num_threads(2)

MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)


@dataclasses.dataclass
class Side:
    """One package's scheduler, request and config classes."""
    Scheduler: Any
    Request: Any
    ServeConfig: Any

    def req(self, rid, state, prompt_len=100, pos=0, kv=0, out=0,
            max_new=8):
        r = self.Request(rid=rid, adapter_id=0,
                         prompt=list(range(prompt_len)),
                         max_new_tokens=max_new)
        r.state = state
        r.prefill_pos = pos
        r.kv_len = kv
        r.output = list(range(out))
        return r


PORT = Side(tscheduler.IterationScheduler, tengine.Request, TServeConfig)
REF = Side(jscheduler.IterationScheduler, jengine.Request, JServeConfig)


def plan_view(plan):
    return dict(rows=[(rp.req.rid, rp.kind, rp.start, rp.q_len)
                      for rp in plan.rows],
                total=plan.total_tokens, budget=plan.budget,
                mixed=plan.is_mixed, q_max=plan.q_max)


def both(script):
    """``script(side)`` -> (plan, extra) on the port and the reference:
    the port's plan and extra, after checking the reference made the same
    plan."""
    (got, extra), (want, _) = script(PORT), script(REF)
    assert plan_view(got) == plan_view(want)
    return got, extra


# ---------------------------------------------------- planning invariants
def test_budget_never_exceeded_and_decode_priority():
    def script(s):
        sc = s.ServeConfig(max_batch=4, max_prefill_tokens=32,
                           max_prefill_batch=8, iteration_token_budget=40)
        running = [s.req(i, "decode", kv=50, out=2) for i in range(3)] + \
            [s.req(10 + i, "prefill", prompt_len=200) for i in range(4)]
        return s.Scheduler(sc).plan(running), sc

    plan, sc = both(script)
    assert plan.total_tokens <= max(plan.budget, len(plan.decode_rows))
    assert plan.total_tokens <= 40
    # decode rows first, all of them, q=1 at the request's kv_len
    assert [rp.kind for rp in plan.rows[:3]] == ["decode"] * 3
    assert all(rp.q_len == 1 and rp.start == 50 for rp in plan.decode_rows)
    assert all(rp.q_len <= sc.max_prefill_tokens
               for rp in plan.prefill_rows)


def test_decode_never_starved_by_tiny_budget():
    def script(s):
        sc = s.ServeConfig(max_batch=8, iteration_token_budget=2)
        running = [s.req(i, "decode", kv=50, out=1) for i in range(6)] + \
            [s.req(10, "prefill", prompt_len=100)]
        return s.Scheduler(sc).plan(running), None

    plan, _ = both(script)
    # every decode row runs though the budget (2) cannot cover them;
    # prefill gets nothing this iteration
    assert len(plan.decode_rows) == 6
    assert len(plan.prefill_rows) == 0


def test_decode_capped_at_max_batch_and_exhausted_rows_skipped():
    def script(s):
        sc = s.ServeConfig(max_batch=2, iteration_token_budget=100)
        running = [s.req(i, "decode", kv=50, out=1) for i in range(4)]
        running.append(s.req(9, "decode", kv=50, out=9, max_new=8))
        return s.Scheduler(sc).plan(running), None

    plan, _ = both(script)
    assert len(plan.decode_rows) == 2
    # a request that already has max_new+1 tokens is not schedulable
    assert all(rp.req.rid != 9 for rp in plan.rows)


def test_prefill_chunks_fcfs_with_prompt_and_budget_bounds():
    def script(s):
        sc = s.ServeConfig(max_batch=4, max_prefill_tokens=16,
                           iteration_token_budget=24)
        running = [s.req(1, "prefill", prompt_len=100, pos=90),
                   s.req(2, "prefill", prompt_len=100),
                   s.req(3, "prefill", prompt_len=100)]
        return s.Scheduler(sc).plan(running), None

    plan, _ = both(script)
    q = {rp.req.rid: rp.q_len for rp in plan.prefill_rows}
    # the final chunk: the exact 10-token remainder; mid-prompt chunks: the
    # budget's remainder (14, then 6) clamped down to a power of two
    assert q == {1: 10, 2: 8, 3: 4}
    assert plan.total_tokens == 22
    assert plan.rows[0].end == 100


def test_budget_exhaustion_stops_prefill_packing():
    def script(s):
        sc = s.ServeConfig(max_batch=4, max_prefill_tokens=16,
                           iteration_token_budget=16)
        running = [s.req(1, "prefill", prompt_len=16),
                   s.req(2, "prefill", prompt_len=100)]
        return s.Scheduler(sc).plan(running), None

    plan, _ = both(script)
    assert {rp.req.rid: rp.q_len for rp in plan.prefill_rows} == {1: 16}
    assert plan.total_tokens == 16


def test_first_scheduled_stamped_once():
    def script(s):
        sched = s.Scheduler(s.ServeConfig(iteration_token_budget=64))
        r = s.req(1, "prefill", prompt_len=100)
        sched.plan([r], now=123.0)
        first = r.first_scheduled_at
        return sched.plan([r], now=456.0), (first, r.first_scheduled_at)

    _, stamps = both(script)
    assert stamps == (123.0, 123.0)


def test_default_budget_covers_legacy_throughput():
    """budget=0 derives max_prefill_tokens + max_batch: a full decode batch
    on top of the legacy prefill budget."""
    for s in (PORT, REF):
        sc = s.ServeConfig(max_batch=8, max_prefill_tokens=64)
        assert s.Scheduler(sc).budget == 64 + 8


def test_mixed_plan_flag():
    def script(s):
        sched = s.Scheduler(s.ServeConfig(iteration_token_budget=64))
        both_kinds = sched.plan([s.req(1, "decode", kv=10, out=1),
                                 s.req(2, "prefill", prompt_len=50)])
        decode_only = sched.plan([s.req(1, "decode", kv=10, out=1)])
        return both_kinds, plan_view(decode_only)

    plan, decode_only = both(script)
    assert plan.is_mixed and plan.q_max > 1
    assert not decode_only["mixed"]


def test_verify_rows_planned_as_the_reference():
    """Speculation's hook (DESIGN.md §16): a draft turns a decode row into
    a verify row of q_len 1 + len(draft); a draft is trimmed to the budget
    left, and a row whose draft is trimmed away stays a decode row —
    planned identically by both packages."""
    def script(s):
        sched = s.Scheduler(s.ServeConfig(max_batch=4,
                                          iteration_token_budget=8))
        running = [s.req(1, "decode", kv=40, out=1),
                   s.req(2, "decode", kv=40, out=1),
                   s.req(3, "decode", kv=40, out=1),
                   s.req(4, "prefill", prompt_len=60)]
        drafts = {1: [5, 6, 7, 8], 2: [9, 9, 9, 9], 3: [4]}
        plan = sched.plan(running, propose=lambda r: drafts.get(r.rid, []))
        return plan, [tuple(rp.draft) for rp in plan.verify_rows]

    plan, drafts = both(script)
    assert [(rp.kind, rp.q_len) for rp in plan.rows] == \
        [("verify", 5), ("verify", 3), ("decode", 1)]
    assert drafts == [(5, 6, 7, 8), (9, 9)]
    assert not plan.prefill_rows         # the budget is spent


# ------------------------------------------- unified-grid kernel oracle
def mixed_inputs(seed, window):
    """Random pools + a 3-row batch mixing a decode row (q_len 1), a full
    prefill chunk and a q_len 0 padding row, as numpy arrays."""
    page, hkv, g, d, r, npages, sq = 8, 2, 2, 16, 4, 8, 4
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = dict(
        q=f(3, sq, hkv * g, d), kb=f(npages, page, hkv, d),
        vb=f(npages, page, hkv, d), kr=0.1 * f(npages, page, r),
        vr=0.1 * f(npages, page, r), b_k=0.1 * f(3, r, hkv * d),
        b_v=0.1 * f(3, r, hkv * d),
        bt_b=np.asarray([[0, 1, 2], [3, 4, 5], [0, 0, 0]], np.int32),
        bt_r=np.asarray([[5, 6, 7], [1, 2, 3], [0, 0, 0]], np.int32),
        start=np.asarray([17, 4, 0], np.int32),
        q_len=np.asarray([1, 4, 0], np.int32))
    arrays["kv_len"] = arrays["start"] + arrays["q_len"]
    return arrays, dict(scale=d ** -0.5, window=window)


ORDER = ("q", "kb", "vb", "kr", "vr", "b_k", "b_v", "bt_b", "bt_r", "start",
         "q_len", "kv_len")


def check_rows(got, want, q_len):
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for i, ql in enumerate(q_len):
        np.testing.assert_array_equal(got[i, ql:], 0.0)


@pytest.mark.parametrize("window", [0, 12])
def test_mixed_kernel_matches_ref_oracle(window):
    """The executor's entry for #1 on CPU tensors (its plain version)
    against the reference's mixed oracle, row for row, exact zeros past
    q_len."""
    a, kw = mixed_inputs(0, window)
    rope = dict(rope_theta=10_000.0, use_rope=True)
    got = ops.paged_residual_attention_mixed(
        *(torch.from_numpy(a[k]) for k in ORDER), **kw, **rope)
    want = jref.paged_residual_attention_mixed_ref(
        *(jnp.asarray(a[k]) for k in ORDER), **kw, **rope)
    check_rows(got.numpy(), np.asarray(want), a["q_len"])


@pytest.mark.parametrize("window", [0, 12])
def test_mixed_base_kernel_matches_ref_oracle(window):
    """The executor's entry for #3 (no residual stream) on CPU tensors
    against the reference's oracle."""
    a, kw = mixed_inputs(1, window)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = ops.paged_residual_attention_mixed(
        t["q"], t["kb"], t["vb"], None, None, None, None, t["bt_b"], None,
        t["start"], t["q_len"], t["kv_len"], **kw)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jref.paged_residual_attention_mixed_ref(
        j["q"], j["kb"], j["vb"], None, None, None, None, j["bt_b"], None,
        j["start"], j["q_len"], j["kv_len"], **kw, rope_theta=10_000.0,
        use_rope=True)
    check_rows(got.numpy(), np.asarray(want), a["q_len"])


# --------------------------------------------- stall detection (engine)
def stall(Engine, Request, ServeConfig, cfg, params, lora, **kw):
    sc = ServeConfig(page_size=16, max_pages=12, max_batch=4,
                     max_prefill_tokens=48, max_pages_per_req=10,
                     stall_limit=6, mode="forkkv")
    assert sc.mixed_batching is True     # the default under test
    eng = Engine(cfg, params, lora, sc, **kw)
    rng = np.random.default_rng(0)
    ctx = Request(rid=1, adapter_id=0, max_new_tokens=0, is_context=True,
                  prompt=[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                       96)])
    eng.submit(ctx)
    while ctx.state != "done":
        eng.step()
    pin = eng.pin_prefix(ctx.prompt, 0)  # 6 of 11 pages pinned
    big = Request(rid=2, adapter_id=1, max_new_tokens=4,
                  prompt=[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                       120)])
    eng.submit(big)
    for _ in range(sc.stall_limit + 20):
        if big.state == "done":
            break
        eng.step()
    out = dict(reason=big.finish_reason, error=big.error,
               output=list(big.output), steps=eng.steps,
               stalled=eng.metrics()["stalled"])
    eng.unpin(pin)
    return out


def test_stall_detection_fires_under_mixed_batching():
    """A request that can never allocate (the pool pinned beyond its
    needs) fails with ``stalled`` after ``stall_limit`` empty plans, in
    the same step as on the reference."""
    jcfg = jtiny(**MODEL)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=4)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    got = stall(tengine.Engine, tengine.Request, TServeConfig, ttiny(**MODEL),
                bridge.params_from_jax(to_np(jparams), "cpu"),
                bridge.lora_from_jax(to_np(jlora), "cpu"), device="cpu")
    assert got["reason"] == "stalled"
    assert "stalled" in got["error"] and got["output"] == []
    assert got["stalled"] == 1
    want = stall(jengine.Engine, jengine.Request, JServeConfig, jcfg,
                 jparams, jlora)
    assert (got["reason"], got["steps"]) == (want["reason"], want["steps"])
