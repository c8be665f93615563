"""The port's SSM family (mamba2, ``repro_torch.models.ssm``) against the
JAX package.

Ports ``tests/test_models.py::test_ssm_parity`` (2 layers, d_model 64, 4
value heads, state 16) and goes further: ``forward`` logits; ``prefill`` of
50 tokens and 20 ``decode_step`` s, logits against JAX's prefill/decode and
against JAX's ``forward`` at the same positions; the ``conv``/``ssm`` state
caches after prefill and after decoding; a second prefill chunk continuing
from the cached state; ``_ssd_chunked`` alone at S < CHUNK, at S not a
multiple of CHUNK and from a nonzero initial state; ``_causal_conv`` from a
stored state; the parameter tree's keys, shapes and dtypes; and the
registry entry.  Weights come from the reference's ``init_params`` and
cross to torch through ``repro_torch.bridge``; tokens and SSD inputs are
numpy draws from a seed.  Tolerance: rtol 3e-4, atol 5e-4, the reference's
own (f32: the chunk products sum in another order, and the port writes
the reference's 3- and 4-operand einsums as pairwise products).  The
reference's JAX functions are jitted once per module
(``functools.lru_cache``).  Nothing here needs a card: the family runs no
kernel.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import ModelConfig as JModelConfig
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.core.config import ModelConfig
from repro_torch.models import registry
from repro_torch.models import ssm as tssm

TOL = dict(rtol=3e-4, atol=5e-4)
B, S = 2, 70
FIELDS = dict(name="tssm", family="ssm", num_layers=2, d_model=64,
              num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=97,
              dtype="float32", ssm_state=16, ssm_heads=4, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def ref():
    """(JAX cfg, torch cfg, JAX params, bridged torch params, jitted JAX
    forward / prefill / decode_step), built once."""
    jcfg, tcfg = JModelConfig(**FIELDS), ModelConfig(**FIELDS)
    jparams = jssm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    fwd = jax.jit(lambda p, t: jssm.forward(p, t, jcfg))
    pre = jax.jit(lambda p, t, c: jssm.prefill(p, t, c, jcfg))
    dec = jax.jit(lambda p, t, c, k: jssm.decode_step(p, t, c, k, jcfg))
    return jcfg, tcfg, jparams, tparams, fwd, pre, dec


def _tokens(shape, seed=2):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(
        np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def test_forward_matches_jax():
    jcfg, tcfg, jparams, tparams, fwd, _, _ = ref()
    tokens = _tokens((B, S))
    _close(tssm.forward(tparams, torch.from_numpy(tokens).long(), tcfg),
           fwd(jparams, jnp.asarray(tokens)))


def _prefill_decode(n_prefill, n_decode, chunks=1):
    """Prefill ``n_prefill`` tokens (in ``chunks`` equal chunks) then
    ``n_decode`` greedy-free decode steps over the same token stream, on
    both sides.  Returns (torch logits, JAX logits, torch cache, JAX cache)
    after each phase, as lists."""
    jcfg, tcfg, jparams, tparams, _, pre, dec = ref()
    tokens = _tokens((B, n_prefill + n_decode))
    tt = torch.from_numpy(tokens).long()
    jc = jssm.init_cache(jcfg, B, S)
    tc = tssm.init_cache(tcfg, B, S, device="cpu")
    got, want, caches = [], [], []
    step = n_prefill // chunks
    for lo in range(0, n_prefill, step):
        lg, tc = tssm.prefill(tparams, tt[:, lo:lo + step], tc, tcfg,
                              start=lo)
        jl, jc = pre(jparams, jnp.asarray(tokens[:, lo:lo + step]), jc)
        got.append(lg[:, 0])
        want.append(jl[:, 0])
    caches.append(({k: v.clone() for k, v in tc.items()}, _np(jc)))
    kv_len = torch.full((B,), n_prefill)
    for t in range(n_prefill, n_prefill + n_decode):
        lg, tc = tssm.decode_step(tparams, tt[:, t], tc, kv_len, tcfg)
        jl, jc = dec(jparams, jnp.asarray(tokens[:, t]), jc,
                     jnp.asarray(kv_len.numpy()))
        got.append(lg)
        want.append(jl)
        kv_len = kv_len + 1
    caches.append((tc, _np(jc)))
    return got, want, caches, tokens


def test_prefill_decode_logits_match_jax():
    """Prefill 50, then 20 decode steps: each step's logits equal JAX's
    prefill/decode logits and JAX's ``forward`` at the same position."""
    jcfg, tcfg, jparams, _, fwd, _, _ = ref()
    got, want, _, tokens = _prefill_decode(50, 20)
    full = np.asarray(fwd(jparams, jnp.asarray(tokens)))
    positions = [49] + list(range(50, 70))
    for g, w, p in zip(got, want, positions):
        _close(g, w)
        _close(g, full[:, p])


@pytest.mark.parametrize("phase", ["after_prefill", "after_decode"])
def test_state_caches_match_jax(phase):
    """The conv window and the SSM state (both f32) equal JAX's."""
    _, _, caches, _ = _prefill_decode(50, 20)
    tc, jc = caches[0 if phase == "after_prefill" else 1]
    for name in ("conv", "ssm"):
        assert tc[name].dtype == torch.float32
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])


def test_chunked_prefill_continues_from_the_state():
    """Two prefill chunks of 25 give the logits of JAX's two chunks and of
    one 50-token prefill."""
    got, want, caches, _ = _prefill_decode(50, 0, chunks=2)
    for g, w in zip(got, want):
        _close(g, w)
    one, _, one_caches, _ = _prefill_decode(50, 0)
    _close(got[-1], one[-1].numpy())
    _close(caches[0][0]["ssm"], one_caches[0][0]["ssm"].numpy())


@pytest.mark.parametrize("s,h0", [(40, False), (150, False), (150, True),
                                  (64, True)])
def test_ssd_chunked_matches_jax(s, h0):
    """``_ssd_chunked`` alone: S below CHUNK (one short chunk), S not a
    multiple of CHUNK (padded), and from a nonzero initial state."""
    rng = np.random.default_rng(s + 7 * h0)
    h, p, n = 4, 8, 16
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    x, bm, cm = f(B, s, h, p), f(B, s, n), f(B, s, n)
    dt = np.log1p(np.exp(f(B, s, h)))               # softplus'd, > 0
    a = -np.exp(f(h) * 0.5)
    d_skip = f(h)
    init = f(B, h, p, n) if h0 else np.zeros((B, h, p, n), np.float32)
    y, last = tssm._ssd_chunked(*map(torch.from_numpy,
                                     (x, dt, a, bm, cm, d_skip, init)))
    jy, jlast = jssm._ssd_chunked(*map(jnp.asarray,
                                       (x, dt, a, bm, cm, d_skip, init)))
    assert y.shape == (B, s, h, p) and last.shape == (B, h, p, n)
    _close(y, jy)
    _close(last, jlast)


def test_causal_conv_from_a_stored_state():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((B, 3, 12)).astype(np.float32)
    for state in (None, st):
        out, new = tssm._causal_conv(
            *map(torch.from_numpy, (x, w, b)),
            None if state is None else torch.from_numpy(state))
        jout, jnew = jssm._causal_conv(
            *map(jnp.asarray, (x, w, b)),
            None if state is None else jnp.asarray(state))
        _close(out, jout)
        _close(new, jnew)


def test_params_have_the_references_tree():
    """The port's ``init_params`` gives the reference's keys, shapes and
    dtypes (its draws are its own)."""
    jcfg, tcfg, jparams, _, _, _, _ = ref()
    mine = tssm.init_params(tcfg, 0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path


def test_registry_serves_the_ssm_family():
    """``get_model`` dispatches ``family="ssm"`` to this module, with no
    LoRA stacks and no ForkKV (attention-free), as the reference's
    registry does."""
    _, tcfg, _, tparams, _, _, _ = ref()
    api = registry.get_model(tcfg)
    assert not api.supports_forkkv and api.init_lora_stacks is None
    tok = torch.from_numpy(_tokens((B, 10))).long()
    _close(api.forward(tparams, tok),
           tssm.forward(tparams, tok, tcfg).numpy())
    cache = api.init_cache(B, 16, device="cpu")
    lg, cache = api.prefill(tparams, tok, cache)
    lg2, _ = api.decode_step(tparams, tok[:, 0], cache, torch.full((B,), 10))
    assert lg.shape == (B, 1, 97) and lg2.shape == (B, 97)
