"""The port's ``PagedExecutor`` against the JAX package's, step by step.

Both executors get the same bridged f32 weights and the same page tables,
and run the same plan: a prefill step, a truly mixed step (a decode row, a
chunk continuing mid-page, a fresh prefill), a decode step and, in forkkv
mode, a speculative verify step.  After every step the logits agree to
1e-4, the pool contents to 1e-5 and the greedy tokens exactly.  The dump
pages are left out of the pool comparison: padding rows and CoW-inherited
positions all write there, and which duplicate write lands is unspecified
on both sides.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving.executor import PagedExecutor as JExecutor
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.serving.executor import PagedExecutor as TExecutor

torch.set_num_threads(2)

PAGE = 16
ARCHS = {
    "gqa": dict(num_heads=8, num_kv_heads=2),
    "swa": dict(num_heads=4, num_kv_heads=2, sliding_window=24),
}
SC = dict(page_size=PAGE, max_pages=32, max_batch=4, max_prefill_tokens=48,
          max_pages_per_req=8)
# per request: base pages, residual pages, adapter
REQS = {0: ([0, 1], [10, 11], 1), 1: ([2], [12], 2), 2: ([3], [13], 3)}


@pytest.fixture(scope="module")
def weights():
    """Reference weights per attention flavour, built once per module."""
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
            cache[arch] = (jcfg, jparams, jlora, ttiny(**kw),
                           bridge.params_from_jax(to_np(jparams), "cpu"),
                           bridge.lora_from_jax(to_np(jlora), "cpu"))
        return cache[arch]

    return get


def make_pair(w, mode):
    """Fresh JAX and port executors (empty pools) on the same weights."""
    jcfg, jparams, jlora, tcfg, tparams, tlora = w
    disagg = mode == "forkkv"
    jex = JExecutor(jcfg, jparams, jlora, JServeConfig(mode=mode, **SC),
                    disagg, SC["max_pages_per_req"])
    tex = TExecutor(tcfg, tparams, tlora, TServeConfig(mode=mode, **SC),
                    disagg, SC["max_pages_per_req"], device="cpu")
    return jex, tex


def plan_rows(ex, rows, tokens, disagg):
    """Executor arguments for rows (rid, start, n): each row writes its
    tokens at [start, start+n) into the request's own pages."""
    chunks, starts, aids, btb, btr, wb, wr = [], [], [], [], [], [], []
    for rid, start, n in rows:
        bpages, rpages, aid = REQS[rid]
        chunks.append(tokens[rid][start:start + n])
        starts.append(start)
        aids.append(aid)
        btb.append(bpages)
        btr.append(rpages if disagg else [])
        wb.append([bpages[p // PAGE] for p in range(start, start + n)])
        wr.append([rpages[p // PAGE] for p in range(start, start + n)]
                  if disagg else [ex.dump_page_r] * n)
    return chunks, starts, aids, btb, btr, wb, wr


def assert_pools_match(jex, tex):
    keep_b = [p for p in range(jex.pools.kb.shape[1]) if p != jex.dump_page]
    for name in ("kb", "vb"):
        np.testing.assert_allclose(
            getattr(tex.pools, name)[:, keep_b].numpy(),
            np.asarray(getattr(jex.pools, name))[:, keep_b],
            atol=1e-5, rtol=1e-5)
    if jex.pools.kr is not None:
        keep_r = [p for p in range(jex.pools.kr.shape[1])
                  if p != jex.dump_page_r]
        for name in ("kr", "vr"):
            np.testing.assert_allclose(
                getattr(tex.pools, name)[:, keep_r].numpy(),
                np.asarray(getattr(jex.pools, name))[:, keep_r],
                atol=1e-5, rtol=1e-5)


def assert_step_matches(jout, tout):
    jtok, jlogits = np.asarray(jout[0]), np.asarray(jout[1])
    ttok, tlogits = tout[0].numpy(), tout[1].numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=1e-4, rtol=1e-4)
    assert ttok.tolist() == jtok.tolist()
    assert tout[-1].numpy().tolist() == np.asarray(jout[-1]).tolist()


@pytest.mark.parametrize("arch,mode", [("gqa", "forkkv"), ("gqa", "prefix"),
                                       ("swa", "forkkv")])
def test_mixed_and_decode_steps_match_jax(weights, arch, mode):
    jex, tex = make_pair(weights(arch), mode)
    disagg = mode == "forkkv"
    rng = np.random.default_rng(3)
    tokens = {rid: [int(t) for t in rng.integers(0, 512, 32)]
              for rid in REQS}
    steps = [
        [(0, 0, 20), (1, 0, 7)],               # prefill only
        [(0, 20, 1), (1, 7, 5), (2, 0, 12)],   # decode + mid-page + fresh
    ]
    for rows in steps:
        args = plan_rows(jex, rows, tokens, disagg)
        assert_step_matches(jex.mixed_step(*args), tex.mixed_step(*args))
        assert_pools_match(jex, tex)
    # decode-shaped plan: delegates to decode() on both sides
    args = plan_rows(jex, [(0, 21, 1), (1, 12, 1), (2, 12, 1)], tokens,
                     disagg)
    assert_step_matches(jex.mixed_step(*args), tex.mixed_step(*args))
    assert_pools_match(jex, tex)
    assert tex.decode_cache_size() == 1
    assert tex.fallback_gather_calls == 0


def test_verify_step_matches_jax(weights):
    jex, tex = make_pair(weights("gqa"), "forkkv")
    rng = np.random.default_rng(4)
    tokens = {rid: [int(t) for t in rng.integers(0, 512, 32)]
              for rid in REQS}
    args = plan_rows(jex, [(0, 0, 20), (1, 0, 7)], tokens, True)
    assert_step_matches(jex.mixed_step(*args), tex.mixed_step(*args))
    # verify rows: [last token, drafts...]; greedy_all and the accepted
    # prefix lengths must agree too
    args = plan_rows(jex, [(0, 20, 4), (1, 7, 3)], tokens, True)
    jout = jex.mixed_step(*args, verify=True, qfloor=4)
    tout = tex.mixed_step(*args, verify=True, qfloor=4)
    assert_step_matches(jout, tout)
    assert tout[2].numpy().tolist() == np.asarray(jout[2]).tolist()
    assert tout[3].numpy().tolist() == np.asarray(jout[3]).tolist()
    assert_pools_match(jex, tex)
