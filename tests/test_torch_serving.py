"""The port's ``ForkServer`` against the JAX package's, end to end.

Both servers get the same bridged f32 weights and serve the staggered
session/fork workload of ``tests/test_parity_matrix.py`` (copied here): one
pinned context, two CoW forks under different adapters, the second
submitted while the first is mid-decode so at least one plan mixes decode
and prefill rows, then a replay of fork 1.  Greedy tokens must be
identical.  The port serves on the CPU, so its attention goes through the
plain versions, whose launch counters must move.

The same holds for the reference's other serving paths: the
phase-separated loop (``mixed_batching=False``), the gather-to-contiguous
path (``use_paged_kernel=False``, with the same count of gather calls) and
broadcast fork (``broadcast_fork=True``, with the reference's exact and
amortized prefill accounting).
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
from repro_torch.kernels import ref as tref
from repro_torch.serving.api import ForkServer as TForkServer
from repro_torch.serving.sampling import SamplingParams as TSamplingParams

torch.set_num_threads(2)

PAGE = 16
ARCHS = {
    "gqa": dict(num_heads=8, num_kv_heads=2),
    "mqa": dict(num_heads=4, num_kv_heads=1),
    "swa": dict(num_heads=4, num_kv_heads=2, sliding_window=24),
}
CELLS = [("forkkv", "gqa"), ("forkkv", "mqa"), ("forkkv", "swa"),
         ("prefix", "gqa"), ("full_reuse", "gqa")]


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            kw = dict(rank=8, num_layers=2, d_model=128, vocab_size=512,
                      **ARCHS[arch])
            jcfg = jtiny(**kw)
            jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
            jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1),
                                          n_adapters=4)
            to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
            cache[arch] = (
                (jcfg, jparams, jlora),
                (ttiny(**kw), bridge.params_from_jax(to_np(jparams), "cpu"),
                 bridge.lora_from_jax(to_np(jlora), "cpu")))
        return cache[arch]

    return get


def run_workload(make_server, sc_cls, sp_cls, vocab, mode, **extra):
    """Copy of ``test_parity_matrix.run_workload`` (paged, mixed, plain
    decode), parametrised by the server side; ``extra`` sets more
    ``ServeConfig`` fields."""
    sc = sc_cls(page_size=PAGE, max_pages=96, max_batch=4,
                max_prefill_tokens=48, max_pages_per_req=8, mode=mode,
                **extra)
    server = make_server(sc)
    rng = np.random.default_rng(7)
    ctx = [int(t) for t in rng.integers(0, vocab, 40)]
    with server.session(ctx, adapter_id=0) as sess:
        handles = [sess.fork(1, ctx[:5], sp_cls(max_new_tokens=5))]
        for _ in range(3):       # first fork reaches decode...
            server.poll()
        handles.append(sess.fork(2, ctx[:6], sp_cls(max_new_tokens=5)))
        outs = [o.tokens for o in server.wait(handles)]
        replay = [sess.fork(1, ctx[:5], sp_cls(max_new_tokens=5))]
        outs += [o.tokens for o in server.wait(replay)]
    m = server.metrics()
    eng = server.engine
    eng._evict(eng.base_pool, eng.base_pool.num_pages)
    if mode == "forkkv":
        eng._evict(eng.res_pool, eng.res_pool.num_pages)
    m["drained_free_base"] = eng.base_pool.free_pages
    m["total_base"] = eng.base_pool.num_pages
    m["drained_free_res"] = eng.res_pool.free_pages
    m["total_res"] = eng.res_pool.num_pages
    return outs, m


@pytest.mark.parametrize("mode,arch", CELLS)
def test_port_serves_same_greedy_tokens_as_jax(models, mode, arch):
    (jcfg, jparams, jlora), (tcfg, tparams, tlora) = models(arch)
    jout, jm = run_workload(
        lambda sc: JForkServer(jcfg, jparams, jlora, sc), JServeConfig,
        JSamplingParams, jcfg.vocab_size, mode)
    before = dict(tref.LAUNCHES)
    tout, tm = run_workload(
        lambda sc: TForkServer(tcfg, tparams, tlora, sc, device="cpu"),
        TServeConfig, TSamplingParams, tcfg.vocab_size, mode)
    assert all(len(t) == 5 for t in tout)
    assert tout == jout
    assert tm["mixed_steps"] >= 1
    assert tm["fallback_gather_calls"] == 0
    assert tm["exec_errors"] == 0 and tm["quarantined"] == 0
    assert tm["tasks_done"] == jm["tasks_done"] == 3
    for m in (tm, jm):
        assert m["drained_free_base"] == m["total_base"] - 1
        assert m["drained_free_res"] == m["total_res"] - 1
    for name in ("paged_residual_attention_mixed_ref",
                 "paged_residual_attention_ref"):
        assert tref.LAUNCHES[name] > before[name]


def test_stop_token_finishes_at_its_first_occurrence(models):
    """The stop token is chosen by its FIRST occurrence in the greedy
    output, so the expected prefix is exact even when tokens repeat."""
    _, (tcfg, tparams, tlora) = models("gqa")
    sc = TServeConfig(page_size=PAGE, max_pages=96, max_batch=4,
                      max_prefill_tokens=48, max_pages_per_req=8)
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 512, 20)]
    srv = TForkServer(tcfg, tparams, tlora, sc, device="cpu")
    full = srv.generate(1, prompt, TSamplingParams(max_new_tokens=8)
                        ).result().tokens
    stop = full[3]
    first = full.index(stop)
    srv = TForkServer(tcfg, tparams, tlora, sc, device="cpu")
    out = srv.generate(1, prompt, TSamplingParams(
        max_new_tokens=8, stop_token_ids=(stop,))).result()
    assert out.finish_reason == "stop"
    assert out.tokens == full[:first]


def run_both(models, arch, mode, **extra):
    """The workload on the JAX server and on the port's (CPU), with the
    plain versions' launch counts the port's run added."""
    (jcfg, jparams, jlora), (tcfg, tparams, tlora) = models(arch)
    jout, jm = run_workload(
        lambda sc: JForkServer(jcfg, jparams, jlora, sc), JServeConfig,
        JSamplingParams, jcfg.vocab_size, mode, **extra)
    before = dict(tref.LAUNCHES)
    tout, tm = run_workload(
        lambda sc: TForkServer(tcfg, tparams, tlora, sc, device="cpu"),
        TServeConfig, TSamplingParams, tcfg.vocab_size, mode, **extra)
    ran = {k: v - before[k] for k, v in tref.LAUNCHES.items()}
    assert all(len(t) == 5 for t in tout)
    assert tout == jout
    assert tm["exec_errors"] == 0 and tm["quarantined"] == 0
    assert tm["tasks_done"] == jm["tasks_done"] == 3
    for m in (tm, jm):
        assert m["drained_free_base"] == m["total_base"] - 1
        assert m["drained_free_res"] == m["total_res"] - 1
    return tm, jm, ran


@pytest.mark.parametrize("mode", ["forkkv", "prefix", "full_reuse"])
def test_phase_separated_loop_serves_same_greedy_tokens_as_jax(models,
                                                               mode):
    """``mixed_batching=False``: batched chunked prefill calls (the
    prefill plain version, Pallas #5/#6 on the card) then decode calls."""
    tm, jm, ran = run_both(models, "gqa", mode, mixed_batching=False)
    assert tm["mixed_steps"] == jm["mixed_steps"] == 0
    assert tm["fallback_gather_calls"] == 0
    assert ran["paged_residual_attention_prefill_ref"] > 0
    assert ran["paged_residual_attention_ref"] > 0
    assert ran["paged_residual_attention_mixed_ref"] == 0


@pytest.mark.parametrize("mode", ["forkkv", "prefix"])
def test_gather_path_serves_same_greedy_tokens_as_jax(models, mode):
    """``use_paged_kernel=False``: no paged attention at all, and as many
    gather calls as the reference counts."""
    tm, jm, ran = run_both(models, "gqa", mode, use_paged_kernel=False)
    assert tm["fallback_gather_calls"] > 0
    assert tm["fallback_gather_calls"] == jm["fallback_gather_calls"]
    assert not any(ran.values())


def test_gather_path_phase_separated_sliding_window(models):
    """The gather path under the phase-separated loop on a sliding-window
    model."""
    tm, jm, ran = run_both(models, "swa", "forkkv", use_paged_kernel=False,
                           mixed_batching=False)
    assert tm["fallback_gather_calls"] == jm["fallback_gather_calls"] > 0
    assert not any(ran.values())


def broadcast_run(make_server, sp_cls, vocab):
    """Three agents under adapters 0-2 submitted together with one shared
    64-token prompt (``tests/test_api.py``'s accounting test)."""
    server = make_server()
    shared = [int(t) for t in np.random.default_rng(8).integers(0, vocab, 64)]
    handles = [server.generate(a, list(shared), sp_cls(max_new_tokens=4))
               for a in range(3)]
    outs = server.wait(handles)
    eng = server.engine
    return ([o.tokens for o in outs],
            sorted(int(o.metrics["prefilled_tokens"]) for o in outs),
            [o.metrics["prefill_share"] for o in outs], server.metrics(),
            eng.base_pool.free_pages + eng.base_pool.used_pages)


@pytest.mark.parametrize("mixed", [True, False])
def test_broadcast_fork_matches_jax_and_shares_one_pass(models, mixed):
    """``broadcast_fork=True`` under either loop: the first 48 tokens go
    through ONE base-trajectory pass credited to its writer, each agent
    pays its own 16-token tail, greedy tokens equal JAX's."""
    (jcfg, jparams, jlora), (tcfg, tparams, tlora) = models("gqa")
    kw = dict(page_size=PAGE, max_pages=256, max_batch=6,
              max_prefill_tokens=64, mode="forkkv", max_pages_per_req=12,
              broadcast_fork=True, mixed_batching=mixed)
    jres = broadcast_run(
        lambda: JForkServer(jcfg, jparams, jlora, JServeConfig(**kw)),
        JSamplingParams, jcfg.vocab_size)
    before = dict(tref.LAUNCHES)
    tres = broadcast_run(
        lambda: TForkServer(tcfg, tparams, tlora, TServeConfig(**kw),
                            device="cpu"),
        TSamplingParams, tcfg.vocab_size)
    ttoks, exact, shares, m, pages = tres
    assert ttoks == jres[0] and all(len(t) == 4 for t in ttoks)
    assert exact == jres[1] == [16, 16, 48 + 16]
    for s in shares:
        assert abs(s - (48 / 3 + 16)) < 1e-6, shares
    assert abs(m["prefilled_tokens"] - (48 + 3 * 16)) < 1e-6
    assert sum(exact) < 2.0 * 64
    assert pages == 256
    assert m["exec_errors"] == 0 and m["fallback_gather_calls"] == 0
    # the shared pass attends through the base-only prefill
    assert tref.LAUNCHES["paged_residual_attention_prefill_ref"] > \
        before["paged_residual_attention_prefill_ref"]


def test_quarantine_in_phase_separated_loop(models):
    """Port of ``tests/test_faults.py::test_quarantine_in_phase_separated_loop``:
    the isfinite guard rides the phase-separated prefill and decode
    calls too."""
    _, (tcfg, tparams, tlora) = models("gqa")
    sc = TServeConfig(page_size=16, max_pages=256, max_batch=4,
                      max_prefill_tokens=64, mode="forkkv",
                      max_pages_per_req=12, mixed_batching=False,
                      fault_plan="nan_logits:r1")
    server = TForkServer(tcfg, tparams, tlora, sc, device="cpu")
    prompts = [[int(t) for t in np.random.default_rng(s).integers(
        0, tcfg.vocab_size, n)] for s, n in ((51, 32), (52, 34))]
    handles = [server.generate(1 + i, p, TSamplingParams(max_new_tokens=5))
               for i, p in enumerate(prompts)]
    outs = server.wait(handles)
    assert outs[0].finish_reason == "error"
    assert outs[1].finish_reason == "length" and len(outs[1].tokens) == 5
    assert server.metrics()["quarantined"] == 1
