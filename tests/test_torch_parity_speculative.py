"""The speculative axis of the cross-mode parity matrix
(``tests/test_parity_matrix.py``, DESIGN.md §16) on the port, held to the
JAX package: over {forkkv, prefix, full_reuse} x {dense, GQA} (MQA and SWA
in ``test_torch_parity_speculative_mqa_swa.py``), speculation on must
give the same greedy tokens as speculation off, while really proposing
and accepting drafts, never gathering, and leaking no KV page: after the
session closes and the caches are evicted, both pools are back to
baseline (only the dump page stays).  Each cell's tokens, step count and
``spec_*`` counters also equal the reference's ``ForkServer`` serving the
same workload with speculation on, on the same (bridged) weights.

The workload is the reference matrix's: one pinned 40-token context, two
staggered forks under different adapters whose instructions quote the
context (so the prompt-lookup material exists), then a replay of the first
fork, which the ngram cache (warmed when the first fork finished) drafts.
The paged/gather and mixed/phase-separated axes are in
``test_torch_serving.py``.
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
from repro_torch.serving.sampling import SamplingParams as TSamplingParams

torch.set_num_threads(2)

PAGE = 16
# MHA, grouped-query, multi-query, sliding-window (a window of 24 straddles
# a page boundary and is shorter than the 40-token context)
ARCHS = {
    "dense": dict(num_heads=4, num_kv_heads=4),
    "gqa": dict(num_heads=8, num_kv_heads=2),
    "mqa": dict(num_heads=4, num_kv_heads=1),
    "swa": dict(num_heads=4, num_kv_heads=2, sliding_window=24),
}
MODES = ("forkkv", "prefix", "full_reuse")
COMPARED = ("spec_steps", "spec_proposed_tokens", "spec_accepted_tokens",
            "spec_committed_tokens", "steps")

_MODELS = {}
_CELLS = {}


def models(arch):
    """(reference, port) sides of one attention flavour, each
    (ForkServer, ServeConfig, SamplingParams, cfg, params, lora, kw)."""
    if arch not in _MODELS:
        kw = dict(rank=8, num_layers=2, d_model=128, vocab_size=512,
                  **ARCHS[arch])
        jcfg = jtiny(**kw)
        jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1),
                                      n_adapters=4)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        _MODELS[arch] = (
            (JForkServer, JServeConfig, JSamplingParams, jcfg, jparams,
             jlora, {}),
            (TForkServer, TServeConfig, TSamplingParams, ttiny(**kw),
             bridge.params_from_jax(to_np(jparams), "cpu"),
             bridge.lora_from_jax(to_np(jlora), "cpu"),
             dict(device="cpu")))
    return _MODELS[arch]


def run_workload(side, mode, speculate):
    """The matrix's workload on one side; returns (tokens per fork,
    metrics with the drained pools' free counts)."""
    ForkServer, ServeConfig, SamplingParams, cfg, params, lora, kw = side
    sc = ServeConfig(page_size=PAGE, max_pages=96, max_batch=4,
                     max_prefill_tokens=48, max_pages_per_req=8, mode=mode,
                     speculate=speculate, spec_k=3,
                     spec_proposer="ngram_cache")
    server = ForkServer(cfg, params, lora, sc, **kw)
    rng = np.random.default_rng(7)
    ctx = [int(t) for t in rng.integers(0, cfg.vocab_size, 40)]
    sp = SamplingParams(max_new_tokens=5)
    with server.session(ctx, adapter_id=0) as sess:
        handles = [sess.fork(1, ctx[:5], sp)]
        for _ in range(3):       # the first fork reaches decode...
            server.poll()
        handles.append(sess.fork(2, ctx[:6], sp))
        outs = [o.tokens for o in server.wait(handles)]
        # ...and its replay gets ngram-cache drafts
        outs += [o.tokens for o in server.wait([sess.fork(1, ctx[:5], sp)])]
    m = server.metrics()
    m["steps"] = server.engine.steps
    eng = server.engine
    eng._evict(eng.base_pool, eng.base_pool.num_pages)
    if mode == "forkkv":
        eng._evict(eng.res_pool, eng.res_pool.num_pages)
    m["drained_free_base"] = eng.base_pool.free_pages
    m["total_base"] = eng.base_pool.num_pages
    m["drained_free_res"] = eng.res_pool.free_pages
    m["total_res"] = eng.res_pool.num_pages
    return [[int(t) for t in o] for o in outs], m


def cell(arch, mode, side, speculate):
    """One (arch, mode, side, speculate) run, memoized per module."""
    key = (arch, mode, side, speculate)
    if key not in _CELLS:
        ref, port = models(arch)
        _CELLS[key] = run_workload(ref if side == "jax" else port, mode,
                                   speculate)
    return _CELLS[key]


def check_speculative_cell(arch, mode):
    """The gate of one cell: speculation on equals off on the port, is
    real, page-native and leak-free, and equals the reference's serve."""
    spec_out, spec_m = cell(arch, mode, "torch", True)
    plain_out, plain_m = cell(arch, mode, "torch", False)
    assert all(len(t) == 5 for t in spec_out)
    assert spec_out == plain_out
    assert spec_m["speculate"] is True
    assert spec_m["spec_steps"] >= 1
    assert spec_m["spec_proposed_tokens"] > 0
    assert spec_m["spec_accepted_tokens"] > 0
    assert plain_m["spec_steps"] == 0
    assert spec_m["fallback_gather_calls"] == 0
    assert spec_m["drained_free_base"] == spec_m["total_base"] - 1
    assert spec_m["drained_free_res"] == spec_m["total_res"] - 1
    ref_out, ref_m = cell(arch, mode, "jax", True)
    assert spec_out == ref_out
    assert {k: spec_m[k] for k in COMPARED} == \
        {k: ref_m[k] for k in COMPARED}


@pytest.mark.parametrize("arch", ["dense", "gqa"])
@pytest.mark.parametrize("mode", MODES)
def test_speculative_vs_plain_token_parity(mode, arch):
    check_speculative_cell(arch, mode)
