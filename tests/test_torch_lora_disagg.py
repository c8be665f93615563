"""The port's LoRA runtime math (``core/lora.py``) and disaggregated KV
math (``core/disagg.py``) against the JAX package's, on the same numpy
weights and inputs, f32 at rtol 1e-5 / atol 1e-6 (the same products,
summed in another order).  The inits draw from a ``torch.Generator``, which
cannot give ``jax.random``'s numbers: they are held to the reference's
shapes, dtypes, scaling and statistics instead.  Also the paper's claim
the math rests on: with deferred RoPE, the disaggregated K/V rebuild the
unified ones exactly (up to rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import disagg as jdis
from repro.core import lora as jlora
from repro.core import rope as jrope
from repro_torch.core import disagg as tdis
from repro_torch.core import lora as tlora
from repro_torch.core import rope as trope

TOL = dict(rtol=1e-5, atol=1e-6)
D_IN, D_OUT, R, S, HKV, HD = 64, 32, 8, 12, 2, 16


def _w(rng, scaling=4.0):
    a = rng.standard_normal((D_IN, R)).astype(np.float32) / 8
    b = rng.standard_normal((R, D_OUT)).astype(np.float32) / 4
    return (jlora.LoRAWeights(jnp.asarray(a), jnp.asarray(b), scaling),
            tlora.LoRAWeights(torch.tensor(a), torch.tensor(b), scaling))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_apply_down_up_match(rng):
    jw, tw = _w(rng)
    x = rng.standard_normal((2, S, D_IN)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    _close(tlora.lora_apply(tx, tw), jlora.lora_apply(jx, jw))
    _close(tlora.lora_down(tx, tw), jlora.lora_down(jx, jw))
    r = tlora.lora_down(tx, tw)
    _close(tlora.lora_up(r, tw), jlora.lora_up(jnp.asarray(r.numpy()), jw))


def test_stacked_bgmv_matches(rng):
    """Three adapters stacked; rows pick adapters 2, 0."""
    pairs = [_w(rng, scaling=s) for s in (1.0, 2.0, 0.5)]
    jst = jlora.stack_adapters({i: p[0] for i, p in enumerate(pairs)})
    tst = tlora.stack_adapters({i: p[1] for i, p in enumerate(pairs)})
    np.testing.assert_array_equal(tst.scaling.numpy(),
                                  np.asarray(jst.scaling))
    x = rng.standard_normal((2, S, D_IN)).astype(np.float32)
    ids = np.array([2, 0])
    jr = jlora.bgmv_down(jnp.asarray(x), jst, jnp.asarray(ids))
    tr = tlora.bgmv_down(torch.tensor(x), tst, torch.tensor(ids))
    _close(tr, jr)
    _close(tlora.bgmv_up(tr, tst, torch.tensor(ids)),
           jlora.bgmv_up(jr, jst, jnp.asarray(ids)))
    with pytest.raises(ValueError, match="dense"):
        tlora.stack_adapters({0: pairs[0][1], 2: pairs[1][1]})


@pytest.mark.parametrize("nonzero", [False, True])
def test_inits_follow_the_reference(nonzero):
    """Shapes, dtype, ``alpha / rank`` scaling, B zero (standard init) or
    small (non-degenerate init), A of variance 1/d_in."""
    gen = torch.Generator().manual_seed(0)
    init = tlora.init_lora_nonzero if nonzero else tlora.init_lora
    w = init(gen, 256, 128, 16, alpha=32.0, dtype=torch.float32)
    jinit = jlora.init_lora_nonzero if nonzero else jlora.init_lora
    import jax
    jw = jinit(jax.random.PRNGKey(0), 256, 128, 16, alpha=32.0,
               dtype=jnp.float32)
    assert w.a.shape == jw.a.shape and w.b.shape == jw.b.shape
    assert w.scaling == jw.scaling == 2.0
    assert w.a.var().item() == pytest.approx(1 / 256, rel=0.1)
    if nonzero:
        assert w.b.std().item() == pytest.approx(0.05 / 4, rel=0.1)
    else:
        assert torch.count_nonzero(w.b) == 0
    bf = tlora.init_lora(gen, 8, 8, 4)
    assert bf.a.dtype == torch.bfloat16


def _rope(positions):
    s, c = jrope.rope_sincos(jnp.asarray(positions), HD, 10_000.0)
    ts, tc = trope.rope_sincos(torch.tensor(positions), HD, 10_000.0)
    return (s, c), (ts, tc)


def test_disagg_math_matches(rng):
    """project_base / project_residual / reconstruct_k / reconstruct_v /
    unified_kv against the reference, and the rebuilt K/V equal to the
    unified ones (deferred RoPE is exact by linearity)."""
    kv = HKV * HD
    x = rng.standard_normal((S, D_IN)).astype(np.float32)
    wk = rng.standard_normal((D_IN, kv)).astype(np.float32) / 8
    wv = rng.standard_normal((D_IN, kv)).astype(np.float32) / 8
    pairs = []
    for _ in range(2):
        a = rng.standard_normal((D_IN, R)).astype(np.float32) / 8
        b = rng.standard_normal((R, kv)).astype(np.float32) / 4
        pairs.append((jlora.LoRAWeights(jnp.asarray(a), jnp.asarray(b), 2.0),
                      tlora.LoRAWeights(torch.tensor(a), torch.tensor(b),
                                        2.0)))
    (js, jc), (ts, tc) = _rope(np.arange(S) + 5)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jwk, jwv, twk, twv = (jnp.asarray(wk), jnp.asarray(wv), torch.tensor(wk),
                          torch.tensor(wv))
    jkb, jvb = jdis.project_base(jx, jwk, jwv, js, jc, HKV, HD)
    tkb, tvb = tdis.project_base(tx, twk, twv, ts, tc, HKV, HD)
    _close(tkb, jkb)
    _close(tvb, jvb)
    (jlk, tlk), (jlv, tlv) = pairs
    jkr, jvr = jdis.project_residual(jx, jlk, jlv)
    tkr, tvr = tdis.project_residual(tx, tlk, tlv)
    _close(tkr, jkr)
    _close(tvr, jvr)
    tk = tdis.reconstruct_k(tkb, tkr, tlk, ts, tc, HKV, HD)
    tv = tdis.reconstruct_v(tvb, tvr, tlv, HKV, HD)
    _close(tk, jdis.reconstruct_k(jkb, jkr, jlk, js, jc, HKV, HD))
    _close(tv, jdis.reconstruct_v(jvb, jvr, jlv, HKV, HD))
    uk, uv = tdis.unified_kv(tx, twk, twv, tlk, tlv, ts, tc, HKV, HD)
    jk, jv = jdis.unified_kv(jx, jwk, jwv, jlk, jlv, js, jc, HKV, HD)
    _close(uk, jk)
    _close(uv, jv)
    torch.testing.assert_close(tk, uk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tv, uv, rtol=1e-5, atol=1e-6)
    bk, bv = tdis.unified_kv(tx, twk, twv, None, None, ts, tc, HKV, HD)
    torch.testing.assert_close(bk, tkb)
    torch.testing.assert_close(bv, tvb)


@pytest.mark.parametrize("n,r,kv", [(8, 16, 1024), (1, 64, 4096),
                                    (100, 8, 512)])
def test_memory_ratio_matches(n, r, kv):
    assert tdis.memory_ratio(n, r, kv) == jdis.memory_ratio(n, r, kv)
