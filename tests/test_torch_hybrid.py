"""The port's hybrid (RecurrentGemma) model family against the JAX package.

Ports ``tests/test_models.py::test_hybrid_parity_disagg`` (5 layers,
d_model 64, local window 8, rank 8) to ``repro_torch.models.hybrid``:
``forward`` logits disaggregated, with LoRA folded into K/V and without
LoRA; ``prefill`` + ``decode_step`` over a local ring that wraps; the
port's ``recurrentgemma_9b.tiny()``; the banded path past
``FLASH_THRESHOLD``; and the weight bridge on the hybrid's list of
layers.  Weights come from the reference's ``init_params`` /
``init_lora_stacks`` and cross to torch through ``repro_torch.bridge``;
tokens are numpy draws from a seed.  Logits are held at the reference's
tolerance, rtol 3e-4 and atol 5e-4 (f32: products and softmaxes sum in
another order, and the reference's chunked associative scan rounds
differently from the port's step-by-step scan, by ~1e-6).  On the CPU the
RG-LRU scan and ``forward(disagg=True)``'s attention take the plain
versions through ``kernels.ops``; on the card they take kernels #9 and
#7/#8 (``chip_smoke.py``).  The one global touched, the port's
``FLASH_THRESHOLD``, goes through ``monkeypatch``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_9b as jrg
from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.models import hybrid as jhyb
from repro_torch import bridge
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.core import attention as tattn
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.kernels import ref as tref
from repro_torch.models import hybrid as thyb

TOL = dict(rtol=3e-4, atol=5e-4)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(**kw):
    """test_models.py's hybrid configuration on both sides."""
    base = dict(name="thyb", family="hybrid", num_layers=5, d_model=64,
                num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=97,
                dtype="float32", block_pattern=("rglru", "rglru", "local"),
                local_window=8, lru_width=64, remat=False)
    base.update(kw)
    return (JModelConfig(**base, lora=JLoRAConfig(rank=8)),
            ModelConfig(**base, lora=LoRAConfig(rank=8)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Model:
    """JAX params/LoRA for a config pair and their bridged torch copies."""

    def __init__(self, jcfg, tcfg):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.jparams = jhyb.init_params(jcfg, jax.random.PRNGKey(0))
        self.jlora = jhyb.init_lora_stacks(jcfg, jax.random.PRNGKey(1), 3)
        self.tparams = bridge.params_from_jax(_np(self.jparams),
                                              device="cpu")
        self.tlora = bridge.lora_from_jax(_np(self.jlora), device="cpu")

    def kw(self, setting, ids):
        """(JAX kwargs, torch kwargs): "disagg", "unified_lora" or
        "no_lora"."""
        if setting == "no_lora":
            return {}, {}
        disagg = setting == "disagg"
        return (dict(lora=self.jlora, adapter_ids=jnp.asarray(ids),
                     disagg=disagg),
                dict(lora=self.tlora, adapter_ids=torch.tensor(ids),
                     disagg=disagg))


@pytest.fixture(scope="module")
def model():
    return Model(*_cfgs())


def _tokens(shape, vocab=97, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


SETTINGS = ["disagg", "unified_lora", "no_lora"]


@pytest.mark.parametrize("setting", SETTINGS)
def test_forward_matches_jax(model, setting):
    jkw, tkw = model.kw(setting, [0, 2])
    tokens = _tokens((B, 20))
    _close(thyb.forward(model.tparams, torch.from_numpy(tokens).long(),
                        model.tcfg, **tkw),
           jhyb.forward(model.jparams, jnp.asarray(tokens), model.jcfg,
                        **jkw))


@pytest.mark.parametrize("setting", SETTINGS)
def test_prefill_decode_parity(model, setting):
    """Prefill 12 tokens into an 8-slot local ring (it wraps), then decode
    to 20: the logits equal JAX's prefill/decode and the port's own
    ``forward`` at the same positions, and the caches equal JAX's."""
    S, split = 20, 12
    jkw, tkw = model.kw(setting, [0, 2])
    disagg = setting == "disagg"
    tokens = _tokens((B, S))
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    fwd = thyb.forward(model.tparams, ttok, model.tcfg, **tkw)
    jcache = jhyb.init_cache(model.jcfg, B, 32, disagg=disagg,
                             dtype=jnp.float32)
    tcache = thyb.init_cache(model.tcfg, B, 32, disagg=disagg,
                             dtype=torch.float32, device="cpu")
    assert tcache[2]["k"].shape == (B, 8, 1, 16)        # the ring
    jlg, jcache = jhyb.prefill(model.jparams, jtok[:, :split], jcache,
                               model.jcfg, **jkw)
    tlg, tcache = thyb.prefill(model.tparams, ttok[:, :split], tcache,
                               model.tcfg, **tkw)
    _close(tlg[:, 0], jlg[:, 0])
    _close(tlg[:, 0], fwd[:, split - 1].numpy())
    jkv = jnp.full((B,), split, jnp.int32)
    tkv = torch.full((B,), split, dtype=torch.int32)
    for t in range(split, S):
        jlg, jcache = jhyb.decode_step(model.jparams, jtok[:, t], jcache,
                                       jkv, model.jcfg, **jkw)
        tlg, tcache = thyb.decode_step(model.tparams, ttok[:, t], tcache,
                                       tkv, model.tcfg, **tkw)
        _close(tlg, jlg)
        _close(tlg, fwd[:, t].numpy())
        jkv, tkv = jkv + 1, tkv + 1
    for jc, tc in zip(jcache, tcache):
        assert set(jc) == set(tc)
        for name in jc:
            _close(tc[name], jc[name])


def test_chunked_prefill_carries_the_recurrent_state(model):
    """Two prefill chunks (the second starts with the first's conv inputs
    and RG-LRU state, and overwrites ring slots its queries still need)
    equal one prefill of both and JAX's chunked prefill."""
    jkw, tkw = model.kw("disagg", [1, 0])
    tokens = _tokens((B, 14), seed=5)
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jcache = jhyb.init_cache(model.jcfg, B, 32, disagg=True,
                             dtype=jnp.float32)
    tcache = thyb.init_cache(model.tcfg, B, 32, disagg=True,
                             dtype=torch.float32, device="cpu")
    for lo, hi in ((0, 5), (5, 14)):
        jlg, jcache = jhyb.prefill(model.jparams, jtok[:, lo:hi], jcache,
                                   model.jcfg, start=lo, **jkw)
        tlg, tcache = thyb.prefill(model.tparams, ttok[:, lo:hi], tcache,
                                   model.tcfg, start=lo, **tkw)
        _close(tlg, jlg)
    whole = thyb.forward(model.tparams, ttok, model.tcfg, **tkw)
    _close(tlg[:, 0], whole[:, -1].numpy())


def test_recurrentgemma_tiny_matches_jax():
    """The port's ``tiny()`` equals the reference's field for field, and
    its disaggregated forward and one prefill + decode step equal JAX's."""
    assert dataclasses.asdict(trg.tiny()) == dataclasses.asdict(jrg.tiny())
    m = Model(jrg.tiny(), trg.tiny())
    jkw, tkw = m.kw("disagg", [2, 1])
    tokens = _tokens((B, 24), vocab=m.tcfg.vocab_size, seed=3)
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    _close(thyb.forward(m.tparams, ttok, m.tcfg, **tkw),
           jhyb.forward(m.jparams, jtok, m.jcfg, **jkw))
    jcache = jhyb.init_cache(m.jcfg, B, 32, disagg=True)
    tcache = thyb.init_cache(m.tcfg, B, 32, disagg=True, device="cpu")
    jlg, jcache = jhyb.prefill(m.jparams, jtok[:, :20], jcache, m.jcfg,
                               **jkw)
    tlg, tcache = thyb.prefill(m.tparams, ttok[:, :20], tcache, m.tcfg,
                               **tkw)
    _close(tlg, jlg)
    jlg, _ = jhyb.decode_step(m.jparams, jtok[:, 20], jcache,
                              jnp.full((B,), 20, jnp.int32), m.jcfg, **jkw)
    tlg, _ = thyb.decode_step(m.tparams, ttok[:, 20], tcache,
                              torch.full((B,), 20), m.tcfg, **tkw)
    _close(tlg, jlg)


@pytest.mark.parametrize("setting", ["disagg", "no_lora"])
def test_banded_path_past_the_threshold(model, monkeypatch, setting):
    """With the port's ``FLASH_THRESHOLD`` lowered to 16, ``forward`` over
    40 tokens and a first prefill chunk of 32 take
    ``banded_window_attention`` in every local layer; the logits equal
    JAX's (threshold untouched there) and the decode steps equal the
    port's ``forward``."""
    jkw, tkw = model.kw(setting, [2, 1])
    n_local = thyb.num_attention_layers(model.tcfg)
    tokens = _tokens((B, 40), seed=4)
    jtok, ttok = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jref = jhyb.forward(model.jparams, jtok, model.jcfg, **jkw)
    calls = []
    banded = tattn.banded_window_attention
    monkeypatch.setattr(tattn, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "banded_window_attention",
                        lambda *a, **kw: calls.append(1) or banded(*a, **kw))
    fwd = thyb.forward(model.tparams, ttok, model.tcfg, **tkw)
    assert len(calls) == n_local
    _close(fwd, jref)
    cache = thyb.init_cache(model.tcfg, B, 64, disagg=setting == "disagg",
                            dtype=torch.float32, device="cpu")
    lg, cache = thyb.prefill(model.tparams, ttok[:, :32], cache, model.tcfg,
                             **tkw)
    assert len(calls) == 2 * n_local
    _close(lg[:, 0], fwd[:, 31].numpy())
    kv_len = torch.full((B,), 32)
    for t in range(32, 40):
        lg, cache = thyb.decode_step(model.tparams, ttok[:, t], cache,
                                     kv_len, model.tcfg, **tkw)
        _close(lg, fwd[:, t].numpy())
        kv_len = kv_len + 1


def test_forward_runs_the_scan_through_the_dispatcher(model):
    """On CPU tensors every RG-LRU layer's scan and every local layer's
    disaggregated attention take the plain versions, once per layer."""
    _, tkw = model.kw("disagg", [0, 1])
    n_local = thyb.num_attention_layers(model.tcfg)
    before = dict(tref.LAUNCHES)
    thyb.forward(model.tparams, torch.from_numpy(_tokens((B, 9))).long(),
                 model.tcfg, **tkw)
    assert tref.LAUNCHES["rg_lru_scan_ref"] == \
        before["rg_lru_scan_ref"] + model.tcfg.num_layers - n_local
    assert tref.LAUNCHES["residual_attention_ref"] == \
        before["residual_attention_ref"] + n_local


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_list_of_layers_bit_for_bit(dtype):
    """``params_from_jax`` keeps the hybrid's list of heterogeneous layer
    dicts (and a tuple, as a tuple); every leaf round-trips bit for bit."""
    jcfg, _ = _cfgs(dtype=dtype)
    jparams = _np(jhyb.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = bridge.params_from_jax(jparams, device="cpu")
    assert isinstance(tparams["layers"], list)
    assert len(tparams["layers"]) == jcfg.num_layers
    assert [sorted(l) for l in tparams["layers"]] == \
        [sorted(l) for l in jparams["layers"]]
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        for name, arr in jl.items():
            back = bridge.tensor_to_numpy(tl[name])
            assert back.dtype == arr.dtype and back.shape == arr.shape
            assert back.tobytes() == arr.tobytes(), name
    pair = bridge.params_from_jax((jparams["embed"], jparams["unembed"]),
                                  device="cpu")
    assert isinstance(pair, tuple) and len(pair) == 2
    assert bridge.tensor_to_numpy(pair[1]).tobytes() == \
        jparams["unembed"].tobytes()


def test_init_params_and_cache_layout(model):
    """The port's own init draws the reference's tree: the same kinds,
    keys, shapes and dtypes per layer; the caches likewise."""
    tparams = thyb.init_params(model.tcfg, 0, device="cpu")
    jparams = _np(model.jparams)
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jl.items()} \
            == {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tl.items()}
    tlora = thyb.init_lora_stacks(model.tcfg, 1, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in tlora.items()} == \
        {k: tuple(v.shape) for k, v in model.jlora.items()}
    jcache = jhyb.init_cache(model.jcfg, B, 6, disagg=True)
    tcache = thyb.init_cache(model.tcfg, B, 6, disagg=True, device="cpu")
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in tcache] == \
        [{k: tuple(v.shape) for k, v in c.items()} for c in jcache]
