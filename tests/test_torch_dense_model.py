"""The port's dense model API against the JAX package.

Ports ``tests/test_models.py``'s dense cases (forward / prefill / decode
parity, disaggregated against unified, the SWA ring buffer, the banded
path) to ``repro_torch.models.transformer``.  Weights come from the
reference's ``init_params`` / ``init_lora_stacks`` and cross to torch
through ``repro_torch.bridge``; tokens are numpy draws from a seed.
Logits are held to JAX's and to the port's own ``forward`` at the
reference's tolerance, rtol 3e-4 and atol 5e-4 (f32; matrix products and
softmaxes sum in another order on the two sides).  On the CPU,
``forward(disagg=True)`` reaches the dense plain version through
``kernels.ops``; on the card it reaches kernels #7/#8 (``chip_smoke.py``).
The one global touched, the port's ``FLASH_THRESHOLD``, goes through
``monkeypatch``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.configs import recurrentgemma_9b as jrg
from repro.models import hybrid as jhyb
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core import attention as tattn
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.kernels import ref as tref
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.models import hybrid as thyb
from repro_torch.models import registry
from repro_torch.models import transformer as ttfm

TOL = dict(rtol=3e-4, atol=5e-4)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(**kw):
    """The same dense configuration on both sides (``dense_cfg`` of
    tests/test_models.py)."""
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                dtype="float32", remat=False)
    base.update(kw)
    return (JModelConfig(**base, lora=JLoRAConfig(rank=8)),
            ModelConfig(**base, lora=LoRAConfig(rank=8)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Model:
    """JAX params/LoRA for ``cfg`` and their bridged torch copies."""

    def __init__(self, **kw):
        self.jcfg, self.tcfg = _cfgs(**kw)
        self.jparams = jtfm.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.jlora = jtfm.init_lora_stacks(self.jcfg, jax.random.PRNGKey(1),
                                           3)
        self.tparams = bridge.params_from_jax(_np(self.jparams),
                                              device="cpu")
        self.tlora = bridge.lora_from_jax(_np(self.jlora), device="cpu")

    def kw(self, lora, ids, disagg):
        """(JAX kwargs, torch kwargs) of a LoRA setting."""
        if not lora:
            return {}, {}
        return (dict(lora=self.jlora, adapter_ids=jnp.asarray(ids),
                     disagg=disagg),
                dict(lora=self.tlora, adapter_ids=torch.tensor(ids),
                     disagg=disagg))


def _tokens(shape, vocab=97, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


# (model kwargs, lora, adapter ids, disagg, S, split)
PARITY = {
    "gqa_disagg": (dict(), True, [0, 2], True, 16, 10),
    "gqa_unified_lora": (dict(), True, [1, 0], False, 16, 10),
    "mqa_disagg": (dict(num_kv_heads=1), True, [2, 1], True, 16, 10),
    "swa_ring": (dict(sliding_window=6), False, None, False, 20, 12),
    "swa_ring_disagg": (dict(sliding_window=6), True, [0, 1], True, 20, 12),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_prefill_decode_parity(case):
    """Prefill the first ``split`` tokens, then decode the rest one at a
    time: the logits equal the port's own ``forward`` and JAX's
    prefill/decode at the same positions (ports test_models.py's
    ``_prefill_decode_parity``)."""
    mkw, lora, ids, disagg, S, split = PARITY[case]
    m = Model(**mkw)
    jkw, tkw = m.kw(lora, ids, disagg)
    tokens = _tokens((B, S))
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jref = jtfm.forward(m.jparams, jtok, m.jcfg, **jkw)
    tref_ = ttfm.forward(m.tparams, ttok, m.tcfg, **tkw)
    _close(tref_, jref)

    jcache = jtfm.init_cache(m.jcfg, B, 32, disagg=disagg, dtype=jnp.float32)
    tcache = ttfm.init_cache(m.tcfg, B, 32, disagg=disagg,
                             dtype=torch.float32, device="cpu")
    jlg, jcache = jtfm.prefill(m.jparams, jtok[:, :split], jcache, m.jcfg,
                               **jkw)
    tlg, tcache = ttfm.prefill(m.tparams, ttok[:, :split], tcache, m.tcfg,
                               **tkw)
    _close(tlg[:, 0], jlg[:, 0])
    _close(tlg[:, 0], tref_[:, split - 1].numpy())
    jkv = jnp.full((B,), split, jnp.int32)
    tkv = torch.full((B,), split, dtype=torch.int32)
    for t in range(split, S):
        jlg, jcache = jtfm.decode_step(m.jparams, jtok[:, t], jcache, jkv,
                                       m.jcfg, **jkw)
        tlg, tcache = ttfm.decode_step(m.tparams, ttok[:, t], tcache, tkv,
                                       m.tcfg, **tkw)
        _close(tlg, jlg)
        _close(tlg, tref_[:, t].numpy())
        jkv, tkv = jkv + 1, tkv + 1
    for name in jcache:
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("setting", ["disagg", "unified_lora", "no_lora"])
def test_forward_matches_jax(setting):
    m = Model()
    jkw, tkw = m.kw(setting != "no_lora", [0, 2], setting == "disagg")
    tokens = _tokens((B, 12))
    _close(ttfm.forward(m.tparams, torch.from_numpy(tokens).long(), m.tcfg,
                        **tkw),
           jtfm.forward(m.jparams, jnp.asarray(tokens), m.jcfg, **jkw))


def test_disagg_equals_unified_single_trajectory():
    """On one request the disaggregated math is exact: the port's
    ``forward`` with ``disagg=True`` (the dense plain version) equals the
    unified one (LoRA folded into K/V, ``mha``)."""
    m = Model()
    tok = torch.from_numpy(_tokens((B, 12))).long()
    ids = torch.tensor([0, 2])
    a = ttfm.forward(m.tparams, tok, m.tcfg, lora=m.tlora, adapter_ids=ids)
    b = ttfm.forward(m.tparams, tok, m.tcfg, lora=m.tlora, adapter_ids=ids,
                     disagg=True)
    _close(a, b.numpy())


def test_forward_at_one_token_goes_through_the_dispatcher():
    """S = 1 with ``disagg=True`` takes ``kernels.ops.residual_attention``
    once per layer (the decode kernel on the card, the plain version
    here), and equals JAX."""
    m = Model()
    tokens = _tokens((B, 1))
    jkw, tkw = m.kw(True, [1, 2], True)
    before = tref.LAUNCHES["residual_attention_ref"]
    got = ttfm.forward(m.tparams, torch.from_numpy(tokens).long(), m.tcfg,
                       **tkw)
    assert tref.LAUNCHES["residual_attention_ref"] == \
        before + m.tcfg.num_layers
    _close(got, jtfm.forward(m.jparams, jnp.asarray(tokens), m.jcfg, **jkw))


def test_chunked_prefill_over_a_ring_matches_jax():
    """Two prefill chunks shorter than the window (the second overwrites
    ring slots its own queries still need), then decode: the cache and the
    logits equal JAX's."""
    m = Model(sliding_window=6)
    jkw, tkw = m.kw(True, [0, 1], True)
    tokens = _tokens((B, 14), seed=5)
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jcache = jtfm.init_cache(m.jcfg, B, 32, disagg=True, dtype=jnp.float32)
    tcache = ttfm.init_cache(m.tcfg, B, 32, disagg=True, device="cpu",
                             dtype=torch.float32)
    for lo, hi in ((0, 4), (4, 9)):
        jlg, jcache = jtfm.prefill(m.jparams, jtok[:, lo:hi], jcache,
                                   m.jcfg, start=lo, **jkw)
        tlg, tcache = ttfm.prefill(m.tparams, ttok[:, lo:hi], tcache,
                                   m.tcfg, start=lo, **tkw)
        _close(tlg, jlg)
    jkv = jnp.full((B,), 9, jnp.int32)
    tkv = torch.full((B,), 9)
    for t in range(9, 14):
        jlg, jcache = jtfm.decode_step(m.jparams, jtok[:, t], jcache, jkv,
                                       m.jcfg, **jkw)
        tlg, tcache = ttfm.decode_step(m.tparams, ttok[:, t], tcache, tkv,
                                       m.tcfg, **tkw)
        _close(tlg, jlg)
        jkv, tkv = jkv + 1, tkv + 1
    for name in jcache:
        _close(tcache[name], jcache[name])


def test_banded_prefill_parity_through_model(monkeypatch):
    """The banded-window path equals the dense one: with the port's
    ``FLASH_THRESHOLD`` lowered to 16, ``forward`` and a ring-cache
    prefill of 32 tokens take ``banded_window_attention``; the logits
    equal JAX's (threshold untouched there) and the port's decode steps
    equal its ``forward`` (ports test_models.py's banded test)."""
    m = Model(sliding_window=8)
    tokens = _tokens((B, 48))
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jref = jtfm.forward(m.jparams, jtok, m.jcfg)
    calls = []
    banded = tattn.banded_window_attention
    monkeypatch.setattr(tattn, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "banded_window_attention",
                        lambda *a, **kw: calls.append(1) or banded(*a, **kw))
    ref = ttfm.forward(m.tparams, ttok, m.tcfg)
    assert len(calls) == m.tcfg.num_layers
    _close(ref, jref)
    cache = ttfm.init_cache(m.tcfg, B, 64, dtype=torch.float32, device="cpu")
    lg, cache = ttfm.prefill(m.tparams, ttok[:, :32], cache, m.tcfg)
    assert len(calls) == 2 * m.tcfg.num_layers
    _close(lg[:, 0], ref[:, 31].numpy())
    kv_len = torch.full((B,), 32)
    for t in range(32, 40):
        lg2, cache = ttfm.decode_step(m.tparams, ttok[:, t], cache, kv_len,
                                      m.tcfg)
        _close(lg2, ref[:, t].numpy())
        kv_len = kv_len + 1


def test_get_model_dense():
    m = Model()
    api = registry.get_model(m.tcfg)
    assert api.supports_forkkv
    tok = torch.from_numpy(_tokens((B, 8))).long()
    ids = torch.tensor([2, 0])
    want = ttfm.forward(m.tparams, tok, m.tcfg, lora=m.tlora,
                        adapter_ids=ids, disagg=True)
    got = api.forward(m.tparams, tok, lora=m.tlora, adapter_ids=ids,
                      disagg=True)
    assert torch.equal(got, want)
    cache = api.init_cache(B, 16, disagg=True, device="cpu")
    assert cache["k"].shape == (2, B, 16, 2, 16)
    assert cache["k_res"].shape == (2, B, 16, 8)
    lg, cache = api.prefill(m.tparams, tok, cache, lora=m.tlora,
                            adapter_ids=ids, disagg=True)
    _close(lg[:, 0], want[:, -1].numpy())
    lg, _ = api.decode_step(m.tparams, tok[:, 0], cache,
                            torch.full((B,), 8), lora=m.tlora,
                            adapter_ids=ids, disagg=True)
    assert lg.shape == (B, m.tcfg.vocab_size)
    params = api.init_params(0, device="cpu")
    lora = api.init_lora_stacks(1, 3, device="cpu")
    assert params["layers"]["wq"].shape == (2, 64, 64)
    assert lora["a_k"].shape == (2, 3, 64, 8)


@pytest.mark.parametrize("family,arch,module", [
    ("ssm", "mamba2-130m", "ssm"), ("audio", "whisper-large-v3", "encdec")])
def test_get_model_serves_the_ssm_and_audio_families(family, arch, module):
    """``family="ssm"`` and ``family="audio"`` are served by their modules
    (``models/ssm.py``, ``models/encdec.py``): the API's ``forward`` and
    ``init_cache`` are the module's (their parity with JAX is held in
    tests/test_torch_ssm.py and tests/test_torch_encdec.py)."""
    import importlib
    from repro_torch import configs as tconfigs
    mod = importlib.import_module(f"repro_torch.models.{module}")
    cfg = tconfigs.get_tiny_config(arch)
    assert cfg.family == family
    api = registry.get_model(cfg)
    params = api.init_params(0, device="cpu")
    tok = torch.from_numpy(_tokens((B, 6))).long() % cfg.vocab_size
    kw = {}
    if family == "audio":
        kw["extra_embeds"] = torch.zeros(B, cfg.encoder_seq, cfg.d_model)
    assert torch.equal(api.forward(params, tok, **kw),
                       mod.forward(params, tok, cfg, **kw))
    cache = api.init_cache(B, 8, device="cpu")
    want = mod.init_cache(cfg, B, 8, device="cpu")
    assert {k: v.shape for k, v in cache.items()} == \
        {k: v.shape for k, v in want.items()}


def test_get_model_serves_the_hybrid_family():
    """``family="hybrid"`` is served by ``repro_torch.models.hybrid``: the
    API's ``forward``, ``init_cache``, ``prefill`` and ``decode_step`` are
    the module's, on weights bridged from the reference."""
    jcfg, cfg = _cfgs(family="hybrid", num_layers=3, num_kv_heads=1,
                      block_pattern=("rglru", "rglru", "local"),
                      local_window=8, lru_width=64)
    jparams = _np(jhyb.init_params(jcfg, jax.random.PRNGKey(0)))
    jlora = _np(jhyb.init_lora_stacks(jcfg, jax.random.PRNGKey(1), 3))
    params = bridge.params_from_jax(jparams, device="cpu")
    lora = bridge.lora_from_jax(jlora, device="cpu")
    api = registry.get_model(cfg)
    assert api.supports_forkkv
    tok = torch.from_numpy(_tokens((B, 10))).long()
    kw = dict(lora=lora, adapter_ids=torch.tensor([2, 0]), disagg=True)
    want = thyb.forward(params, tok, cfg, **kw)
    assert torch.equal(api.forward(params, tok, **kw), want)
    cache = api.init_cache(B, 16, disagg=True, device="cpu")
    assert [sorted(c) for c in cache] == [["conv", "h"]] * 2 + \
        [["k", "k_res", "v", "v_res"]]
    lg, cache = api.prefill(params, tok[:, :9], cache, **kw)
    _close(lg[:, 0], want[:, 8].numpy())
    lg, _ = api.decode_step(params, tok[:, 9], cache, torch.full((B,), 9),
                            **kw)
    _close(lg, want[:, 9].numpy())
    assert len(api.init_params(0, device="cpu")["layers"]) == 3
    assert api.init_lora_stacks(1, 3, device="cpu")["a_k"].shape == \
        (1, 3, 64, 8)


def test_recurrentgemma_9b_config_matches_jax():
    """The port's RecurrentGemma-9B configuration equals the reference's
    field for field, at 9,189,720,064 parameters."""
    assert dataclasses.asdict(trg.CONFIG) == dataclasses.asdict(jrg.CONFIG)
    assert trg.CONFIG.num_params == jrg.CONFIG.num_params == 9_189_720_064
    assert thyb.layer_kinds(trg.CONFIG).count("local") == 12
    assert thyb.num_attention_layers(trg.CONFIG) == 12


@pytest.mark.parametrize("kw", [dict(), dict(sliding_window=6)],
                         ids=["full", "ring"])
def test_int8_init_cache(kw):
    """An int8 cache has JAX's entries, shapes and dtypes: int8 K/V, f32
    per-(position, head) scales, residual caches in the activation dtype;
    a prefill + decode step over it writes the scales."""
    jcfg, tcfg = (dataclasses.replace(c, kv_quant="int8")
                  for c in _cfgs(**kw))
    jc = jtfm.init_cache(jcfg, B, 16, disagg=True)
    tc = ttfm.init_cache(tcfg, B, 16, disagg=True, device="cpu")
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype), name
    m = Model(**kw)
    _, tkw = m.kw(True, [0, 1], True)
    tok = torch.from_numpy(_tokens((B, 5))).long()
    _, tc = ttfm.prefill(m.tparams, tok[:, :4], tc, tcfg, **tkw)
    _, tc = ttfm.decode_step(m.tparams, tok[:, 4], tc,
                             torch.full((B,), 4, dtype=torch.int32), tcfg,
                             **tkw)
    assert (tc["k_scale"][:, :, :5] > 0).all()
    assert (tc["k_scale"][:, :, 5:] == 0).all()


def test_init_cache_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means cuda")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttfm.init_cache(cfg, B, 16)
