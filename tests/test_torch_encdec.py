"""The port's audio family (whisper, ``repro_torch.models.encdec``) against
the JAX package.

Ports ``tests/test_models.py::test_whisper_parity`` (2 encoder and 2
decoder layers, d_model 64, 4 heads, 24 frames, no RoPE, tied unembedding)
and goes further: ``encode``, ``fill_cross_cache`` and ``forward`` with
frames; ``prefill`` of a 10-token chunk with frames, a second chunk of 6
without them (the cross cache kept) and 6 ``decode_step`` s, in the
``no_lora``, ``unified`` (LoRA folded into K/V) and ``disagg`` settings,
logits and every cache against JAX's; ``forward`` ignoring ``lora``, as
the reference's does; ``_sinusoid``; the parameter tree; and the registry
entry.  Weights come from the reference's ``init_params`` /
``tfm.init_lora_stacks`` and cross to torch through ``repro_torch.bridge``;
tokens and frames are numpy draws from a seed.  Tolerance: rtol 3e-4, atol
5e-4, the reference's own (f32 sums in another order).  The reference's
JAX functions are jitted once per module (``functools.lru_cache``).  On the
CPU everything runs plain torch: the decoder's cached self-attention is
the gather path's plain attention on both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.models import encdec as jenc
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.models import encdec as tenc
from repro_torch.models import registry

TOL = dict(rtol=3e-4, atol=5e-4)
B, SE, D, V = 2, 24, 64, 97
FIELDS = dict(name="tw", family="audio", num_layers=2, d_model=D,
              num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=V,
              dtype="float32", use_rope=False, is_encoder_decoder=True,
              num_encoder_layers=2, encoder_seq=SE, frontend="audio_stub",
              mlp_activation="gelu", tie_embeddings=True, remat=False)
SETTINGS = ["no_lora", "unified", "disagg"]


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
    """JAX and torch configs, params and LoRA stacks (3 adapters of rank 8
    over the decoder's layers), and the jitted JAX API, built once."""
    jcfg = JModelConfig(**FIELDS, lora=JLoRAConfig(rank=8))
    tcfg = ModelConfig(**FIELDS, lora=LoRAConfig(rank=8))
    jparams = jenc.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), 3)
    m = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jlora=jlora,
             tparams=bridge.params_from_jax(_np(jparams), device="cpu"),
             tlora=bridge.lora_from_jax(_np(jlora), device="cpu"))
    m["encode"] = jax.jit(lambda p, f: jenc.encode(p, f, jcfg))
    m["forward"] = jax.jit(lambda p, t, f: jenc.forward(
        p, t, jcfg, extra_embeds=f))
    # the first chunk (frames, from 0) and the second (none, from 10)
    m["prefill"] = {
        (s, frames): jax.jit(functools.partial(
            _jprefill, cfg=jcfg, setting=s, frames=frames,
            start=0 if frames else 10))
        for s in SETTINGS for frames in (True, False)}
    m["decode"] = {s: jax.jit(functools.partial(_jdecode, cfg=jcfg,
                                                setting=s))
                   for s in SETTINGS}
    return m


def _jkw(setting, lora, ids):
    if setting == "no_lora":
        return {}
    return dict(lora=lora, adapter_ids=ids, disagg=setting == "disagg")


def _jprefill(p, t, c, f, lora, ids, *, cfg, setting, frames, start):
    return jenc.prefill(p, t, c, cfg, start=start,
                        extra_embeds=f if frames else None,
                        **_jkw(setting, lora, ids))


def _jdecode(p, t, c, k, lora, ids, *, cfg, setting):
    return jenc.decode_step(p, t, c, k, cfg, **_jkw(setting, lora, ids))


def _tkw(setting, lora, ids):
    if setting == "no_lora":
        return {}
    return dict(lora=lora, adapter_ids=torch.tensor(ids),
                disagg=setting == "disagg")


def _draws(seed=3, s=22):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, SE, D)).astype(np.float32),
            rng.integers(0, V, (B, s)).astype(np.int32))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def test_encode_matches_jax():
    m = ref()
    frames, _ = _draws()
    _close(tenc.encode(m["tparams"], torch.from_numpy(frames), m["tcfg"]),
           m["encode"](m["jparams"], jnp.asarray(frames)))


def test_fill_cross_cache_matches_jax():
    m = ref()
    frames, _ = _draws()
    enc = m["encode"](m["jparams"], jnp.asarray(frames))
    want = jenc.fill_cross_cache(m["jparams"], enc,
                                 jenc.init_cache(m["jcfg"], B, 8), m["jcfg"])
    got = tenc.fill_cross_cache(
        m["tparams"], torch.from_numpy(np.array(enc)),
        tenc.init_cache(m["tcfg"], B, 8, device="cpu"), m["tcfg"])
    for name in ("xk", "xv"):
        _close(got[name], want[name])


@pytest.mark.parametrize("setting", SETTINGS)
def test_forward_matches_jax_and_ignores_lora(setting):
    """``forward`` with frames equals JAX's; like the reference's it runs
    the decoder's self-attention unadapted, so every setting gives the
    no-LoRA logits."""
    m = ref()
    frames, tokens = _draws()
    got = tenc.forward(m["tparams"], torch.from_numpy(tokens).long(),
                       m["tcfg"], extra_embeds=torch.from_numpy(frames),
                       **_tkw(setting, m["tlora"], [0, 2]))
    _close(got, m["forward"](m["jparams"], jnp.asarray(tokens),
                             jnp.asarray(frames)))
    with pytest.raises(ValueError, match="frame embeddings"):
        tenc.forward(m["tparams"], torch.from_numpy(tokens).long(),
                     m["tcfg"])


def _serve(setting):
    """A 10-token prefill with frames, a 6-token chunk without them, then
    6 decode steps, on both sides.  Returns [(torch logits, JAX logits)]
    and the two final caches."""
    m = ref()
    frames, tokens = _draws()
    ids = [0, 2]
    jl, jids = m["jlora"], jnp.asarray(ids)
    tkw = _tkw(setting, m["tlora"], ids)
    disagg = setting == "disagg"
    jc = jenc.init_cache(m["jcfg"], B, 32, disagg=disagg)
    tc = tenc.init_cache(m["tcfg"], B, 32, disagg=disagg, device="cpu")
    tt = torch.from_numpy(tokens).long()
    out = []
    for lo, hi, with_frames in ((0, 10, True), (10, 16, False)):
        lg, tc = tenc.prefill(
            m["tparams"], tt[:, lo:hi], tc, m["tcfg"], start=lo,
            extra_embeds=torch.from_numpy(frames) if with_frames else None,
            **tkw)
        jlg, jc = m["prefill"][(setting, with_frames)](
            m["jparams"], jnp.asarray(tokens[:, lo:hi]), jc,
            jnp.asarray(frames), jl, jids)
        out.append((lg[:, 0], jlg[:, 0]))
    kv_len = torch.full((B,), 16)
    for t in range(16, 22):
        lg, tc = tenc.decode_step(m["tparams"], tt[:, t], tc, kv_len,
                                  m["tcfg"], **tkw)
        jlg, jc = m["decode"][setting](
            m["jparams"], jnp.asarray(tokens[:, t]), jc,
            jnp.asarray(kv_len.numpy()), jl, jids)
        out.append((lg, jlg))
        kv_len = kv_len + 1
    return out, tc, _np(jc)


@pytest.mark.parametrize("setting", SETTINGS)
def test_prefill_decode_logits_match_jax(setting):
    out, _, _ = _serve(setting)
    for got, want in out:
        _close(got, want)


@pytest.mark.parametrize("setting", SETTINGS)
def test_caches_match_jax(setting):
    """Self K/V (and the residual caches when disaggregated) and the cross
    K/V, which the second chunk keeps, equal JAX's."""
    _, tc, jc = _serve(setting)
    assert sorted(tc) == sorted(jc)
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])


def test_prefill_matches_forward_without_lora():
    """Without LoRA, the prefill/decode logits equal ``forward``'s at the
    same positions (test_whisper_parity's check)."""
    m = ref()
    frames, tokens = _draws()
    full = tenc.forward(m["tparams"], torch.from_numpy(tokens).long(),
                        m["tcfg"], extra_embeds=torch.from_numpy(frames))
    out, _, _ = _serve("no_lora")
    for (got, _), pos in zip(out, [9, 15] + list(range(16, 22))):
        _close(got, full[:, pos].numpy())


def test_sinusoid_matches_jax():
    """The frequencies exp(-i log(1e4) / (d/2 - 1)) differ from XLA's by at
    most one f32 ulp (torch's and XLA's exp), so the angle p * f, and with
    it sin/cos, by at most p * 2^-23 (f <= 1): the bound at each set of
    positions, up to whisper's 448 and up to 32767."""
    for top in (448, 32767):
        pos = np.asarray([[0, 1, 7, top], [3, top // 2, top - 1, 2]],
                         np.int32)
        for d in (64, 1280, 6):
            _close(tenc._sinusoid(torch.from_numpy(pos), d),
                   jenc._sinusoid(jnp.asarray(pos), d), rtol=0,
                   atol=max(top * 2.0 ** -23, 1e-6))


def test_params_have_the_references_tree():
    m = ref()
    mine = tenc.init_params(m["tcfg"], 0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(_np(m["jparams"]))[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), mine))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path


def test_registry_serves_the_audio_family():
    """``get_model`` dispatches ``family="audio"`` to this module, with
    ForkKV on the decoder's self-attention and LoRA stacks over the
    decoder's layers, as the reference's registry does."""
    m = ref()
    api = registry.get_model(m["tcfg"])
    assert api.supports_forkkv
    lora = api.init_lora_stacks(1, 3, device="cpu")
    assert lora["a_k"].shape == (2, 3, D, 8)
    frames, tokens = _draws()
    tok = torch.from_numpy(tokens[:, :10]).long()
    cache = api.init_cache(B, 16, disagg=True, device="cpu")
    lg, cache = api.prefill(m["tparams"], tok, cache,
                            extra_embeds=torch.from_numpy(frames), lora=lora,
                            adapter_ids=torch.tensor([1, 0]), disagg=True)
    lg2, _ = api.decode_step(m["tparams"], tok[:, 0], cache,
                             torch.full((B,), 10), lora=lora,
                             adapter_ids=torch.tensor([1, 0]), disagg=True)
    assert lg.shape == (B, 1, V) and lg2.shape == (B, V)
    assert torch.isfinite(lg2).all()
