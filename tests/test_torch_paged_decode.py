"""Paged-native serving decode on the port (DESIGN.md §12): the tests of
``tests/test_paged_decode.py`` — decode shape buckets stay logarithmic in
``max_batch``, the step-phase metrics are filled, and a batched prefill
gives the same greedy tokens as one request at a time — and the overrun of
a whole-page prompt hit in full, a behaviour of the reference the port
keeps.

The port serves on the CPU with weights bridged from the reference's; the
workloads that shape greedy output also run on the reference's
``ForkServer`` (computed once per module): greedy tokens and step counts
must be identical, and so must the count of decode shapes (the port's
shape buckets, the reference's compiled decode variants).
"""
import math

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

MODEL = dict(rank=8, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             vocab_size=512)


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
    """The reference's result of a workload, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = WORKLOADS[name](model["jax"])
        return cache[name]

    return get


def make_server(side, max_batch=4):
    ForkServer, ServeConfig, _, cfg, params, lora, kw = side
    sc = ServeConfig(page_size=16, max_pages=192, max_batch=max_batch,
                     max_prefill_tokens=64, mode="forkkv",
                     max_pages_per_req=12)
    return ForkServer(cfg, params, lora, sc, **kw)


def tokens(outs):
    return [[int(t) for t in o.tokens] for o in outs]


def fluctuating(side):
    """Five requests of staggered generation lengths shrink the live
    decode batch 5 -> 1; then one more request on the same server."""
    server = make_server(side, max_batch=8)
    sp = side[2]
    rng = np.random.default_rng(1)
    v = MODEL["vocab_size"]
    handles = [server.generate(i, [int(t) for t in rng.integers(0, v,
                                                                20 + i)],
                               sp(max_new_tokens=2 * i + 2))
               for i in range(5)]
    outs = tokens(server.wait(handles))
    variants = server.metrics()["decode_jit_variants"]
    again = tokens(server.wait([server.generate(
        9, [int(t) for t in rng.integers(0, v, 24)],
        sp(max_new_tokens=4))]))
    return dict(outputs=outs, again=again, variants=variants,
                variants_after=server.metrics()["decode_jit_variants"],
                steps=server.engine.steps)


def concurrent(side):
    """Three prompts prefilled together (co-scheduled chunks)."""
    server = make_server(side)
    sp = side[2]
    hs = [server.generate(i + 1, p, sp(max_new_tokens=5))
          for i, p in enumerate(PROMPTS)]
    return dict(outputs=tokens(server.wait(hs)), steps=server.engine.steps)


def full_hit(side):
    """A whole-page prompt (64 tokens) served twice under one adapter, so
    the second request hits its prompt in full: with 12 new tokens, and
    with 16, where prompt + new tokens fill whole pages too."""
    sp = side[2]
    prompt = [int(t) for t in np.random.default_rng(4).integers(
        0, MODEL["vocab_size"], 64)]
    out = []
    for new in (12, 16):
        server = make_server(side)
        outs = [server.generate(1, prompt, sp(max_new_tokens=new)).result()
                for _ in range(2)]
        out.append(dict(tokens=tokens(outs),
                        reasons=[o.finish_reason for o in outs],
                        errors=[o.error for o in outs],
                        steps=server.engine.steps))
    return out


rng3 = np.random.default_rng(3)
PROMPTS = [[int(t) for t in rng3.integers(0, MODEL["vocab_size"],
                                          30 + 7 * i)]
           for i in range(3)]
WORKLOADS = {"fluctuating": fluctuating, "concurrent": concurrent,
             "full_hit": full_hit}


def test_decode_jit_variants_logarithmic(model, jref):
    """A fluctuating decode batch: the executor buckets the batch to
    powers of two (<= max_batch), so the decode shapes seen are bounded by
    log2(max_batch) + 1, and a second workload adds none."""
    got = fluctuating(model["torch"])
    for i, toks in enumerate(got["outputs"]):
        assert len(toks) == 2 * i + 2
    # batch sizes 5, 4, 3, 2, 1 were live; buckets {8, 4, 2, 1} at most
    assert 1 <= got["variants"] <= int(math.log2(8)) + 1
    assert got["variants_after"] == got["variants"]
    want = jref("fluctuating")
    assert (got["outputs"], got["again"], got["steps"]) == \
        (want["outputs"], want["again"], want["steps"])
    if want["variants"] >= 0:            # the reference's jit cache probe
        assert got["variants"] == want["variants"]


def test_phase_metrics_populated(model):
    """Step-phase wall clock: prefill and decode both ran, and the one
    host read per step is timed (finite and non-negative)."""
    side = model["torch"]
    server = make_server(side)
    rng = np.random.default_rng(2)
    h = server.generate(1, [int(t) for t in rng.integers(
        0, MODEL["vocab_size"], 40)], side[2](max_new_tokens=4))
    assert len(server.wait([h])[0].tokens) == 4
    m = server.metrics()
    assert m["prefill_ms"] > 0
    assert m["decode_ms"] > 0
    assert m["sync_ms"] >= 0
    assert m["decode_steps"] >= 4


def test_batched_prefill_matches_sequential(model, jref):
    """A batched multi-request prefill does not change outputs: three
    concurrent requests give the same greedy tokens as the same prompts
    submitted one at a time, and the reference's concurrent serve."""
    side = model["torch"]
    got = concurrent(side)
    server = make_server(side)
    sequential = []
    for i, p in enumerate(PROMPTS):
        h = server.generate(i + 1, p, side[2](max_new_tokens=5))
        sequential.append(tokens(server.wait([h]))[0])
    assert got["outputs"] == sequential
    assert got == jref("concurrent")


def test_page_aligned_full_hit_as_the_reference(model, jref):
    """A behaviour of the reference the port keeps (ROADMAP Queue 3): a
    request whose whole-page prompt is cached in full is admitted straight
    to decode, and its first decode step feeds the prompt's last token
    again at position len(prompt), so it takes one position more than
    admission allocates.  When prompt + max_new tokens fill whole pages,
    its last step writes past its block table and the executor error
    fails the plan — on both engines, at the same step."""
    got = full_hit(model["torch"])
    assert got == jref("full_hit")
    fits, overruns = got
    assert fits["reasons"] == ["length", "length"]
    assert overruns["reasons"] == ["length", "error"]
    assert "list index out of range" in overruns["errors"][1]
    assert len(overruns["tokens"][1]) == 15  # the last step never ran
