"""Speculative decoding on the port (``repro_torch.serving.speculate`` and
the engine's verify rows, DESIGN.md §16) against the JAX package's: the
tests of ``tests/test_speculate.py``.

* Units — proposers, the accept rule, adaptive k — run on the port's
  module and give the same answers as ``repro.serving.speculate`` on the
  same inputs.
* Engine tests run the port's ``ForkServer`` on the CPU with weights
  bridged from the reference's; each scenario that shapes greedy output
  also runs on the reference's ``ForkServer`` (computed once per module):
  greedy tokens, engine step counts and the ``spec_*`` counters must be
  identical.  The model is a small ``tiny_serving_model`` (2 layers,
  d_model 128: head_dim 32).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving import speculate as jspec
from repro.serving.api import ForkServer as JForkServer
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.serving import speculate as tspec
from repro_torch.serving.api import ForkServer as TForkServer
from repro_torch.serving.sampling import SamplingParams as TSamplingParams

torch.set_num_threads(2)

MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)
SPEC_KEYS = ("spec_steps", "spec_proposed_tokens", "spec_accepted_tokens",
             "spec_committed_tokens")


def both(script):
    """``script(speculate_module, ServeConfig)`` on the port and on the
    reference: the port's result, after checking the reference's is the
    same."""
    got = script(tspec, TServeConfig)
    want = script(jspec, JServeConfig)
    assert got == want, (got, want)
    return got


# ------------------------------------------------------------- proposers
def test_prompt_lookup_matches_most_recent_longest_ngram():
    def script(spec, _):
        p = spec.PromptLookupProposer(max_ngram=3, min_ngram=2)
        # the suffix (7, 8) occurred earlier, followed by 9, 1; the longest
        # n wins: (7, 8, 9) matches over the 2-gram site
        return (p.propose([1, 7, 8, 9, 1, 5, 7, 8], 2),
                p.propose([7, 8, 9, 4, 2, 7, 8, 9], 1))

    assert both(script) == ([9, 1], [4])


def test_prompt_lookup_no_match_and_k0():
    def script(spec, _):
        p = spec.PromptLookupProposer()
        return (p.propose([1, 2, 3, 4, 5], 4), p.propose([1, 2, 1, 2], 0),
                p.propose([1], 4))

    assert both(script) == ([], [], [])


def test_ngram_cache_replays_observed_sequence():
    def script(spec, _):
        p = spec.NGramCacheProposer(max_ngram=3, min_ngram=2, cont_len=8)
        p.observe([10, 11, 12, 13, 14, 15, 16])
        # a fresh request reaching ...11, 12 continues as the observed one
        return p.propose([40, 41, 11, 12], 3), p.stats()

    draft, stats = both(script)
    assert draft == [13, 14, 15]
    assert stats["hits"] == 1


def test_ngram_cache_bounded_memory_lru():
    def script(spec, _):
        p = spec.NGramCacheProposer(max_ngram=2, min_ngram=2, max_entries=8)
        for i in range(100):
            p.observe([i, i + 1, i + 2])
        # the oldest entries evicted, the newest retained
        return len(p), p.propose([99, 100], 1), p.propose([0, 1], 1)

    size, newest, oldest = both(script)
    assert size <= 8
    assert newest == [101]
    assert oldest != [2]


def test_ngram_cache_falls_back_to_prompt_lookup():
    def script(spec, _):
        p = spec.NGramCacheProposer(max_ngram=3, min_ngram=2)
        # a cold cache, but the request's own tokens self-match
        return p.propose([5, 6, 7, 1, 5, 6], 1), p.stats()["misses"]

    assert both(script) == ([7], 1)


def test_make_proposer_dispatch():
    def script(spec, ServeConfig):
        names = [spec.make_proposer(ServeConfig()).name,
                 spec.make_proposer(
                     ServeConfig(spec_proposer="ngram_cache")).name]
        with pytest.raises(ValueError):
            spec.make_proposer(ServeConfig(spec_proposer="oracle"))
        return names

    assert both(script) == ["prompt_lookup", "ngram_cache"]


# ------------------------------------------------------------ accept rule
def test_longest_accepted_prefix():
    cases = (([], []), ([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 9, 3]),
             ([9, 2], [1, 2]))
    got = both(lambda spec, _: [spec.longest_accepted_prefix(d, g)
                                for d, g in cases])
    assert got == [0, 3, 1, 0]


# ------------------------------------------------------------- adaptive k
def test_adaptive_k_backs_off_and_recovers():
    def script(spec, _):
        ctl = spec.AdaptiveK(k_max=8)
        ks = [ctl.k]                          # optimistic start
        for _ in range(6):                    # a garbage proposer
            ctl.update(8, 0)
        ks.append(ctl.k)
        for _ in range(12):                   # a replayed trace
            ctl.update(ctl.k, ctl.k)
        return ks + [ctl.k]

    # sustained rejection converges to k_min, acceptance recovers k_max
    assert both(script) == [8, 1, 8]


def test_adaptive_k_ignores_empty_steps():
    def script(spec, _):
        ctl = spec.AdaptiveK(k_max=4)
        ctl.update(0, 0)                      # no proposal this step
        return ctl.k, ctl.ema

    assert both(script) == (4, 1.0)


# ----------------------------------------------------- engine integration
@pytest.fixture(scope="module")
def model():
    jcfg = jtiny(**MODEL)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=8)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jax=(jcfg, jparams, jlora, jspec, JServeConfig,
                     JForkServer, JSamplingParams, {}),
                torch=(ttiny(**MODEL),
                       bridge.params_from_jax(to_np(jparams), "cpu"),
                       bridge.lora_from_jax(to_np(jlora), "cpu"), tspec,
                       TServeConfig, TForkServer, TSamplingParams,
                       dict(device="cpu")))


@pytest.fixture(scope="module")
def jref(model):
    """The reference's result of a scenario, computed once per module."""
    cache = {}

    def get(name, *args):
        if name not in cache:
            cache[name] = SCENARIOS[name](model["jax"], *args)
        return cache[name]

    return get


def make_server(side, **kw):
    cfg, params, lora, _, ServeConfig, ForkServer, _, skw = side
    base = dict(page_size=16, max_pages=128, max_batch=4,
                max_prefill_tokens=64, mode="forkkv", max_pages_per_req=12)
    base.update(kw)
    return ForkServer(cfg, params, lora, ServeConfig(**base), **skw)


def stub(side, fn):
    """A deterministic draft source over ``side``'s ``Proposer``."""
    class _StubProposer(side[3].Proposer):
        name = "stub"

        def propose(self, tokens, k):
            return [int(t) for t in fn(list(tokens), k)]

    return _StubProposer()


def prompt_tokens(n, seed=0):
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, MODEL["vocab_size"], n)]


def spec_view(server, out=None):
    m = server.metrics()
    view = {k: m[k] for k in SPEC_KEYS}
    view["steps"] = server.engine.steps
    view["fallback_gather_calls"] = m["fallback_gather_calls"]
    if out is not None:
        view["tokens"] = [int(t) for t in out.tokens]
        view["request"] = (out.metrics["spec_proposed"],
                           out.metrics["spec_accepted"])
    return view


def run_one(side, proposer_fn=None, speculate=True, **kw):
    server = make_server(side, speculate=speculate, spec_k=4,
                         spec_adaptive=False, **kw)
    if proposer_fn is not None:
        server.engine.proposer = stub(side, proposer_fn)
    out = server.generate(1, prompt_tokens(40, seed=3),
                          side[6](max_new_tokens=10)).result()
    return spec_view(server, out)


# ------------------------------------------------------------- scenarios
def plain(side):
    return run_one(side, speculate=False)


def all_rejected(side):
    return run_one(side, proposer_fn=lambda t, k: [0] * k)


def oracle(side, full):
    return run_one(side, proposer_fn=lambda t, k: full[len(t):len(t) + k])


def opt_out(side):
    server = make_server(side, speculate=True, spec_k=4)
    out = server.generate(1, prompt_tokens(40, seed=5),
                          side[6](max_new_tokens=6, speculate=False)).result()
    return spec_view(server, out)


def opt_in(side):
    server = make_server(side, speculate=False, spec_proposer="ngram_cache")
    prompt = prompt_tokens(40, seed=6)
    sp = side[6]
    # warm: the first request is observed at its finish; the replay opts in
    first = server.generate(1, prompt, sp(max_new_tokens=8)).result()
    out = server.generate(1, prompt, sp(max_new_tokens=8,
                                        speculate=True)).result()
    view = spec_view(server, out)
    view["first"] = [int(t) for t in first.tokens]
    return view


def stall(side):
    server = make_server(side, max_pages=12, stall_limit=8, speculate=True)
    sess = server.session(prompt_tokens(96, seed=6))     # pins 6 pages
    # a disjoint prompt needing more pages than can ever be freed
    out = server.generate(1, prompt_tokens(120, seed=7),
                          side[6](max_new_tokens=4)).result()
    view = spec_view(server, out)
    view.update(reason=out.finish_reason,
                stalled=server.metrics()["stalled"])
    sess.close()
    return view


def billing(side):
    server = make_server(side, admission="fairshare", speculate=True,
                         spec_adaptive=False, spec_k=4)
    server.engine.proposer = stub(side, lambda t, k: [0] * k)
    prompt = prompt_tokens(32, seed=7)
    out = server.generate(1, prompt, side[6](max_new_tokens=8),
                          tenant="a").result()
    view = spec_view(server, out)
    view["service"] = server.engine.policy.tenant("a").service
    return view


SCENARIOS = {"plain": plain, "all_rejected": all_rejected, "oracle": oracle,
             "opt_out": opt_out, "opt_in": opt_in, "stall": stall,
             "billing": billing}


def test_all_rejected_drafts_keep_token_parity(model, jref):
    """A proposer feeding pure garbage costs steps, never tokens: the
    committed stream equals plain decode bit for bit, and every rejected
    draft's KV is dropped without a gather fallback."""
    base = plain(model["torch"])
    got = all_rejected(model["torch"])
    assert got["tokens"] == base["tokens"]
    assert got["spec_proposed_tokens"] > 0
    assert got["spec_accepted_tokens"] == 0
    assert got["fallback_gather_calls"] == 0
    assert got["request"][0] > 0 and got["request"][1] == 0
    assert got == jref("all_rejected")


def test_oracle_proposer_accepts_everything_in_fewer_steps(model, jref):
    """An oracle proposing the true continuation gets every draft accepted
    and finishes in fewer engine steps than plain decode."""
    base = plain(model["torch"])
    full = prompt_tokens(40, seed=3) + base["tokens"]
    got = oracle(model["torch"], full)
    assert got["tokens"] == base["tokens"]
    assert got["spec_accepted_tokens"] == got["spec_proposed_tokens"] > 0
    assert got["steps"] < base["steps"], \
        "full acceptance must compress the step count"
    assert got == jref("oracle", full)


def test_k0_and_per_request_opt_out_degenerate_to_plain_decode(model, jref):
    """A per-request ``speculate=False`` and a sampled request (the
    greedy-only rule) both run plain decode rows: no verify step."""
    side = model["torch"]
    got = opt_out(side)
    assert len(got["tokens"]) == 6
    assert got["spec_steps"] == 0
    assert got == jref("opt_out")
    server = make_server(side, speculate=True, spec_k=4)
    out = server.generate(1, prompt_tokens(40, seed=5),
                          side[6](max_new_tokens=6, temperature=0.7,
                                  seed=9)).result()
    assert len(out.tokens) == 6
    assert server.metrics()["spec_steps"] == 0


def test_per_request_opt_in_with_engine_default_off(model, jref):
    got = opt_in(model["torch"])
    assert got["spec_steps"] > 0 and got["spec_accepted_tokens"] > 0
    assert len(got["tokens"]) == 8
    assert got == jref("opt_in")


def test_stall_detection_still_fires_with_speculation(model, jref):
    """Speculation does not mask the no-progress stall detector: an
    impossible-to-admit request still fails loudly."""
    got = stall(model["torch"])
    assert got["reason"] == "stalled"
    assert got["stalled"] == 1
    assert got == jref("stall")


def test_fairshare_bills_accepted_not_proposed_tokens(model, jref):
    """Admission billing settles to the tokens actually generated: the
    rejected drafts are never service."""
    got = billing(model["torch"])
    assert got["spec_proposed_tokens"] > 0
    assert got["service"] == pytest.approx(32 + 8)
    assert got["service"] < 32 + 8 + got["spec_proposed_tokens"]
    assert got == jref("billing")
