"""int8 bCache pages and int8 dense caches in the port, against the JAX
package (port of ``tests/test_kv_quant.py``).

* The plain int8 versions of all six paged entries (decode, chunked
  prefill, mixed; disaggregated and base-only) read the same int8 pages
  and scales as JAX's Pallas kernels (interpret mode) and JAX's ref
  mirror, and agree with both within ``ATOL_BACKEND``; the int8 output
  stays within 5% of the full-precision output's max |value|.
* ``quantize_kv`` is bit-identical to JAX's on f32 and bf16 input.
* A dense int8 cache (``prefill`` + ``decode_step``) gives JAX's logits at
  rtol 3e-4 / atol 5e-4, and the caches' int8 values and scales equal.
* Serving with ``kv_quant="int8"`` gives JAX's greedy tokens in forkkv and
  prefix mode, on the paged path (no gather call) and the gather path.

Inputs are numpy draws from a seed; weights cross through
``repro_torch.bridge``.  On the card the same entries reach the int8
variants of the CUDA kernels (``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.core.config import ServeConfig as JServeConfig
from repro.kernels import ops as jops
from repro.models import transformer as jtfm
from repro.serving.api import ForkServer as JForkServer
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model as ttiny
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.serving.api import ForkServer as TForkServer
from repro_torch.serving.sampling import SamplingParams as TSamplingParams

PAGE = 16
P = 8          # pool pages
HKV = 2
HQ = 4
D = 64
R = 4
W = 3          # block-table width
ATOL_BACKEND = 1e-3   # same int8 pages, f32 math: accumulation noise only
QUALITY_TOL = 0.05    # int8 vs full precision, share of the max |value|
TOL = dict(rtol=3e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------- kernels
def _case(kind, disagg, seed):
    """JAX and torch arguments of one entry on int8 pools quantized by JAX,
    plus the torch arguments over the full-precision pools."""
    rng = np.random.default_rng(seed)
    kb = jnp.asarray(rng.standard_normal((P, PAGE, HKV, D)), jnp.float32)
    vb = jnp.asarray(rng.standard_normal((P, PAGE, HKV, D)), jnp.float32)
    kq, ks = jtfm.quantize_kv(kb)
    vq, vs = jtfm.quantize_kv(vb)
    kr = rng.standard_normal((P, PAGE, R)).astype(np.float32)
    vr = rng.standard_normal((P, PAGE, R)).astype(np.float32)
    bsz, chunk = 2, 8
    bt_b = rng.permutation(P - 1)[: bsz * W].reshape(bsz, W).astype(np.int32)
    bt_r = rng.permutation(P - 1)[: bsz * W].reshape(bsz, W).astype(np.int32)
    b_k = (rng.standard_normal((bsz, R, HKV * D)) * 0.1).astype(np.float32)
    b_v = (rng.standard_normal((bsz, R, HKV * D)) * 0.1).astype(np.float32)
    if kind == "decode":
        q = rng.standard_normal((bsz, HQ, D)).astype(np.float32)
        rows = (np.asarray([PAGE * W - 3, PAGE + 5], np.int32),)
    elif kind == "prefill":
        q = rng.standard_normal((bsz, chunk, HQ, D)).astype(np.float32)
        start = np.asarray([PAGE, 4], np.int32)
        rows = (start, start + chunk)
    else:   # mixed: a decode row (q_len 1) beside a prefill row
        q = rng.standard_normal((bsz, chunk, HQ, D)).astype(np.float32)
        start = np.asarray([PAGE + 7, 4], np.int32)
        q_len = np.asarray([1, chunk], np.int32)
        rows = (start, q_len, start + q_len)
    res = (kr, vr, b_k, b_v) if disagg else (None,) * 4

    def args(to, k, v):
        tail = [to(bt_b), to(bt_r) if disagg else None] + [to(a)
                                                          for a in rows]
        return [to(q), to(k), to(v)] + [None if a is None else to(a)
                                        for a in res] + tail

    jargs = args(jnp.asarray, kq, vq)
    targs = args(_t, np.asarray(kq), np.asarray(vq))
    full = args(_t, np.asarray(kb), np.asarray(vb))
    scales = (jnp.asarray(ks), jnp.asarray(vs)), (_t(ks), _t(vs))
    return jargs, targs, full, scales


ENTRIES = {"decode": ("paged_residual_attention",
                      "paged_residual_attention_ref"),
           "prefill": ("paged_residual_attention_prefill",
                       "paged_residual_attention_prefill_ref"),
           "mixed": ("paged_residual_attention_mixed",
                     "paged_residual_attention_mixed_ref")}


@pytest.mark.parametrize("disagg", [True, False],
                         ids=["disagg", "base-only"])
@pytest.mark.parametrize("kind", list(ENTRIES))
def test_int8_plain_versions_match_pallas_and_ref(kind, disagg):
    """The port's plain int8 version of each entry against JAX's Pallas
    kernel in interpret mode and JAX's ref mirror on the same int8 pages;
    the port's dispatcher on CPU tensors runs that plain version; the int8
    output stays within ``QUALITY_TOL`` of the full-precision output."""
    jargs, targs, full, ((jks, jvs), (tks, tvs)) = _case(
        kind, disagg, seed=["decode", "prefill", "mixed"].index(kind))
    op, ref_name = ENTRIES[kind]
    jkw = dict(scale=D ** -0.5, kb_scale=jks, vb_scale=jvs)
    o_ref = np.asarray(getattr(jops, op)(*jargs, backend="ref", **jkw))
    o_pal = np.asarray(getattr(jops, op)(*jargs, backend="pallas",
                                         interpret=True, **jkw))
    tkw = dict(scale=D ** -0.5, kb_scale=tks, vb_scale=tvs)
    before = tref.LAUNCHES[ref_name]
    got = getattr(tops, op)(*targs, **tkw).numpy()
    assert tref.LAUNCHES[ref_name] == before + 1
    direct = getattr(tref, ref_name)(*targs, **tkw).numpy()
    np.testing.assert_array_equal(got, direct)
    if kind == "prefill":
        # rows at or past n_valid are padding the caller ignores: the
        # reference's two backends compute them differently
        valid = np.arange(8)[None] < (targs[-1] - targs[-2]).numpy()[:, None]
        got, o_ref, o_pal = got[valid], o_ref[valid], o_pal[valid]
    np.testing.assert_allclose(got, o_ref, atol=ATOL_BACKEND,
                               rtol=ATOL_BACKEND)
    np.testing.assert_allclose(got, o_pal, atol=ATOL_BACKEND,
                               rtol=ATOL_BACKEND)
    if kind == "mixed":        # rows past q_len are exact zeros
        assert np.all(got[0, 1:] == 0.0)
    o_fp = getattr(tops, op)(*full, scale=D ** -0.5).numpy()
    if kind == "prefill":
        o_fp = o_fp[valid]
    assert np.abs(got - o_fp).max() <= QUALITY_TOL * np.abs(o_fp).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 16, 8, 128)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                      # an all-zero row: the 1e-8 floor
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = bridge.tensor_from_numpy(np.asarray(jx), device="cpu")
    jq, js = jtfm.quantize_kv(jx)
    tq, ts = ttfm.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for out in ("float32", "bfloat16"):
        jd = jtfm.dequantize_kv(jq, js, getattr(jnp, out))
        td = ttfm.dequantize_kv(tq, ts, getattr(torch, out))
        np.testing.assert_array_equal(
            td.float().numpy(), np.asarray(jd, np.float32))


# --------------------------------------------------------- dense caches
def _dense(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                dtype="float32", remat=False, kv_quant="int8")
    base.update(kw)
    jcfg = JModelConfig(**base, lora=JLoRAConfig(rank=8))
    tcfg = ModelConfig(**base, lora=LoRAConfig(rank=8))
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), 3)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (jcfg, jparams, jlora, tcfg,
            bridge.params_from_jax(np_(jparams), device="cpu"),
            bridge.lora_from_jax(np_(jlora), device="cpu"))


@pytest.mark.parametrize("disagg", [True, False],
                         ids=["disagg", "unified"])
def test_int8_dense_cache_prefill_decode_match_jax(disagg):
    """``prefill`` of 10 tokens then 6 ``decode_step`` s over an int8 cache:
    logits equal JAX's within rtol 3e-4 / atol 5e-4, and the caches'
    int8 values equal JAX's up to a rounding tie and their scales within
    f32 rounding."""
    jcfg, jp, jl, tcfg, tp, tl = _dense()
    bsz, split, S = 2, 10, 16
    tokens = np.random.default_rng(4).integers(0, 97, (bsz, S)).astype(
        np.int32)
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jkw = dict(lora=jl, adapter_ids=jnp.asarray([0, 2]), disagg=disagg)
    tkw = dict(lora=tl, adapter_ids=torch.tensor([0, 2]), disagg=disagg)
    jc = jtfm.init_cache(jcfg, bsz, 32, disagg=disagg)
    tc = ttfm.init_cache(tcfg, bsz, 32, disagg=disagg, device="cpu")
    assert set(tc) == set(jc)
    jlg, jc = jtfm.prefill(jp, jtok[:, :split], jc, jcfg, **jkw)
    tlg, tc = ttfm.prefill(tp, ttok[:, :split], tc, tcfg, **tkw)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    jkv = jnp.full((bsz,), split, jnp.int32)
    tkv = torch.full((bsz,), split, dtype=torch.int32)
    for t in range(split, S):
        jlg, jc = jtfm.decode_step(jp, jtok[:, t], jc, jkv, jcfg, **jkw)
        tlg, tc = ttfm.decode_step(tp, ttok[:, t], tc, tkv, tcfg, **tkw)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        jkv, tkv = jkv + 1, tkv + 1
    for name in jc:
        got, want = tc[name].numpy(), np.asarray(jc[name])
        assert got.dtype == want.dtype, name
        if got.dtype == np.int8:          # K/V projections differ by f32
            assert np.abs(got.astype(int) - want).max() <= 1, name
        else:                             # rounding: a tie may round apart
            np.testing.assert_allclose(got, want, **TOL)


# -------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def models_int8():
    kw = dict(rank=8, num_layers=2, d_model=128, vocab_size=512,
              num_heads=8, num_kv_heads=2)
    jcfg = dataclasses.replace(jtiny(**kw), kv_quant="int8")
    tcfg = dataclasses.replace(ttiny(**kw), kv_quant="int8")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=4)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ((jcfg, jparams, jlora),
            (tcfg, bridge.params_from_jax(np_(jparams), "cpu"),
             bridge.lora_from_jax(np_(jlora), "cpu")))


def _serve(server, sp_cls, vocab):
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, vocab, 30 + 9 * i)]
               for i in range(3)]
    hs = [server.generate(i + 1, p, sp_cls(max_new_tokens=6))
          for i, p in enumerate(prompts)]
    return [o.tokens for o in server.wait(hs)], server.metrics()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
@pytest.mark.parametrize("mode", ["forkkv", "prefix"])
def test_int8_serving_matches_jax(models_int8, mode, paged):
    """Greedy serving with int8 bCache pages: the port's tokens equal the
    reference's, on the paged path with no gather call and on the gather
    path with the reference's count of gather calls."""
    (jcfg, jp, jl), (tcfg, tp, tl) = models_int8
    kw = dict(page_size=16, max_pages=96, max_batch=4,
              max_prefill_tokens=48, max_pages_per_req=8, mode=mode,
              use_paged_kernel=paged)
    jtoks, jm = _serve(JForkServer(jcfg, jp, jl, JServeConfig(**kw)),
                       JSamplingParams, jcfg.vocab_size)
    server = TForkServer(tcfg, tp, tl, TServeConfig(**kw), device="cpu")
    assert server.engine.executor.pools.kb.dtype == torch.int8
    ttoks, tm = _serve(server, TSamplingParams, tcfg.vocab_size)
    assert ttoks == jtoks
    assert tm["fallback_gather_calls"] == jm["fallback_gather_calls"]
    assert (tm["fallback_gather_calls"] == 0) == paged
    assert tm["peak_cache_bytes"] == jm["peak_cache_bytes"]


def test_int8_engine_fork_reuse(models_int8):
    """CoW forks over quantized shared pages still hit the radix cache:
    two agents forked off one shared context reuse its int8 pages."""
    tcfg, tp, tl = models_int8[1]
    server = TForkServer(tcfg, tp, tl, TServeConfig(
        page_size=16, max_pages=96, max_batch=4, max_prefill_tokens=48,
        max_pages_per_req=8, mode="forkkv"), device="cpu")
    rng = np.random.default_rng(8)
    shared = [int(t) for t in rng.integers(0, tcfg.vocab_size, 48)]
    outs = []
    for i in range(2):       # sequential: the 2nd forks off the 1st's pages
        h = server.generate(i + 1, shared + [int(t) for t in rng.integers(
            0, tcfg.vocab_size, 8)], TSamplingParams(max_new_tokens=4))
        outs.append(server.wait([h])[0].tokens)
    assert all(len(t) == 4 for t in outs)
    assert server.metrics()["hit_tokens"] > 0


def test_int8_ring_prefill_stays_near_full_precision():
    """A sliding-window model's second prefill chunk attends over the old
    ring and the fresh chunk: over an int8 cache the port dequantizes the
    old ring first, so its logits stay within int8's error of the
    full-precision cache's (the reference concatenates the raw int8 codes
    here; ROADMAP Queue 3)."""
    logits = {}
    for quant in ("none", "int8"):
        _, _, _, tcfg, tp, tl = _dense(sliding_window=6, kv_quant=quant)
        tok = torch.from_numpy(np.random.default_rng(5).integers(
            0, 97, (2, 9))).long()
        kw = dict(lora=tl, adapter_ids=torch.tensor([0, 1]), disagg=True)
        cache = ttfm.init_cache(tcfg, 2, 32, disagg=True, device="cpu")
        for lo, hi in ((0, 4), (4, 9)):
            lg, cache = ttfm.prefill(tp, tok[:, lo:hi], cache, tcfg,
                                     start=lo, **kw)
        logits[quant] = lg.numpy()
    ref_max = np.abs(logits["none"]).max()
    assert np.abs(logits["int8"] - logits["none"]).max() <= \
        QUALITY_TOL * ref_max
