"""The port's model blocks, bridge and configs against the JAX package.

Weights come from the reference's ``init_params`` / ``init_lora_stacks``
and cross to torch through ``repro_torch.bridge``; activations are numpy
draws from a seed.  Blocks are compared in f32 at atol/rtol 1e-5 (matrix
products sum in another order on the two sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.core import config as jconfig
from repro.core import rope as jrope
from repro.models import base as jbase
from repro.models import transformer as jtfm
from repro.serving import sampling as jsampling
from repro_torch import bridge
from repro_torch.configs import paper_models as tpm
from repro_torch.core import config as tconfig
from repro_torch.core import rope as trope
from repro_torch.models import base as tbase
from repro_torch.models import transformer as ttfm
from repro_torch.serving import sampling as tsampling

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = jpm.tiny_serving_model(rank=8, num_layers=2, d_model=128,
                                 vocab_size=512, num_heads=8,
                                 num_kv_heads=2)
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(cfg, jax.random.PRNGKey(1), n_adapters=4)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    tparams = bridge.params_from_jax(to_np(jparams), device="cpu")
    tlora = bridge.lora_from_jax(to_np(jlora), device="cpu")
    tcfg = tpm.tiny_serving_model(rank=8, num_layers=2, d_model=128,
                                  vocab_size=512, num_heads=8,
                                  num_kv_heads=2)
    return cfg, tcfg, jparams, jlora, tparams, tlora


def _layer(tree, li):
    return {k: v[li] for k, v in tree.items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_bridge_round_trip_is_bit_exact(dtype):
    arr = (_x((3, 5, 7)) * 3).astype(dtype)
    t = bridge.tensor_from_numpy(arr, device="cpu")
    assert t.dtype == (torch.float32 if dtype == np.float32
                       else torch.bfloat16)
    back = bridge.tensor_to_numpy(t)
    assert back.dtype == arr.dtype
    assert back.tobytes() == arr.tobytes()


def test_bridged_params_keep_keys_layout_and_bits(model):
    cfg, _, jparams, jlora, tparams, tlora = model
    for jtree, ttree in ((jparams, tparams), (jlora, tlora)):
        jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
        assert len(jflat) == sum(
            1 for _ in jax.tree_util.tree_leaves(ttree,
                                                 is_leaf=torch.is_tensor))
        for path, leaf in jflat:
            t = ttree
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape
            assert bridge.tensor_to_numpy(t).tobytes() == \
                np.asarray(leaf).tobytes()


def test_rms_norm(model):
    x, w = _x((2, 3, 128)), _x((128,), 1) * 0.1
    _close(tbase.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jbase.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_rope():
    pos = np.arange(40, dtype=np.int32).reshape(2, 20) * 37
    ts, tc = trope.rope_sincos(torch.from_numpy(pos), 32, 10_000.0)
    js, jc = jrope.rope_sincos(jnp.asarray(pos), 32, 10_000.0)
    _close(ts, js)
    _close(tc, jc)
    x = _x((2, 20, 4, 32))
    _close(trope.apply_rope(torch.from_numpy(x), ts, tc),
           jrope.apply_rope(jnp.asarray(x), js, jc))


def test_qkv(model):
    cfg, tcfg, jparams, jlora, tparams, tlora = model
    x = _x((3, 5, cfg.d_model)) * 0.5
    aid = np.asarray([0, 3, 1], np.int32)
    pos = np.arange(15, dtype=np.int32).reshape(3, 5) + 4
    tq, tsin, tcos = ttfm._qkv(_layer(tparams["layers"], 1),
                               torch.from_numpy(x), tcfg,
                               _layer(tlora, 1), torch.from_numpy(aid),
                               torch.from_numpy(pos))
    jq, jsin, jcos = jtfm._qkv(_layer(jparams["layers"], 1), jnp.asarray(x),
                               cfg, _layer(jlora, 1), jnp.asarray(aid),
                               jnp.asarray(pos))
    _close(tq, jq)
    _close(tsin, jsin)
    _close(tcos, jcos)


@pytest.mark.parametrize("target", ["q", "k", "v"])
def test_bgmv_and_bgmv_down(model, target):
    cfg, _, _, jlora, _, tlora = model
    x = _x((3, 4, cfg.d_model))
    aid = np.asarray([2, 0, 2], np.int32)
    tl, jl = _layer(tlora, 0), _layer(jlora, 0)
    a, b = f"a_{target}", f"b_{target}"
    _close(ttfm._bgmv(torch.from_numpy(x), tl[a], tl[b], tl["scaling"],
                      torch.from_numpy(aid)),
           jtfm._bgmv(jnp.asarray(x), jl[a], jl[b], jl["scaling"],
                      jnp.asarray(aid)))
    _close(ttfm._bgmv_down(torch.from_numpy(x), tl[a], tl["scaling"],
                           torch.from_numpy(aid)),
           jtfm._bgmv_down(jnp.asarray(x), jl[a], jl["scaling"],
                           jnp.asarray(aid)))


def test_mlp_and_ffn(model):
    cfg, tcfg, jparams, _, tparams, _ = model
    x = _x((2, 3, cfg.d_model))
    tp, jp = _layer(tparams["layers"], 0), _layer(jparams["layers"], 0)
    _close(ttfm.mlp(tp, torch.from_numpy(x), tcfg),
           jtfm.mlp(jp, jnp.asarray(x), cfg))
    _close(ttfm.ffn(tp, torch.from_numpy(x), tcfg),
           jtfm.ffn(jp, jnp.asarray(x), cfg))


def test_embed_and_unembed(model):
    cfg, tcfg, jparams, _, tparams, _ = model
    toks = np.asarray([[1, 7, 511], [0, 3, 3]], np.int32)
    _close(ttfm.embed_tokens(tparams, torch.from_numpy(toks).long(), tcfg),
           jtfm.embed_tokens(jparams, jnp.asarray(toks), cfg))
    x = _x((2, 3, cfg.d_model))
    _close(ttfm.unembed(tparams, torch.from_numpy(x), tcfg),
           jtfm.unembed(jparams, jnp.asarray(x), cfg))


def _fields(cls):
    def default(f):
        if f.default_factory is dataclasses.MISSING:
            return f.default
        return dataclasses.asdict(f.default_factory())
    return [(f.name, default(f)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("tcls,jcls", [
    (tconfig.LoRAConfig, jconfig.LoRAConfig),
    (tconfig.ModelConfig, jconfig.ModelConfig),
    (tconfig.ServeConfig, jconfig.ServeConfig),
    (tsampling.SamplingParams, jsampling.SamplingParams),
])
def test_dataclass_fields_and_defaults_match(tcls, jcls):
    assert _fields(tcls) == _fields(jcls)


def test_paper_models_match():
    for name in ("LLAMA3_8B", "QWEN25_7B", "QWEN25_14B"):
        assert dataclasses.asdict(getattr(tpm, name)) == \
            dataclasses.asdict(getattr(jpm, name))
    assert dataclasses.asdict(tpm.tiny_serving_model(sliding_window=24)) \
        == dataclasses.asdict(jpm.tiny_serving_model(sliding_window=24))
    assert tpm.LLAMA3_8B.activation_dtype == torch.bfloat16
    assert tconfig.PEAK_FLOPS_BF16 == 989e12 and tconfig.HBM_BW == 3.35e12


def test_sampling_greedy_is_first_argmax():
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 5.0                # tie: the first maximum wins
    logits[1, 9] = 1.0
    logits[2] = np.arange(10)[::-1]
    n = lambda v, dt: torch.tensor(v, dtype=dt)  # noqa: E731
    got = tsampling.sample_tokens(
        torch.from_numpy(logits), n([0.0] * 3, torch.float32),
        n([0] * 3, torch.int32), n([1.0] * 3, torch.float32),
        n([0] * 3, torch.int32), n([0] * 3, torch.int32))
    want = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.zeros(3), jnp.zeros(3, jnp.int32),
        jnp.ones(3), jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32))
    assert got.tolist() == np.asarray(want).tolist() == [2, 9, 0]


def test_sampling_seeded_rows_are_deterministic_and_in_top_k():
    logits = torch.from_numpy(_x((4, 64)))
    logits[2] = logits[1]
    args = (torch.tensor([0.0, 0.8, 0.8, 1.5]),
            torch.tensor([0, 5, 5, 0], dtype=torch.int32),
            torch.tensor([1.0, 1.0, 1.0, 0.5]),
            torch.tensor([0, 11, 11, 3], dtype=torch.int32),
            torch.tensor([0, 2, 2, 7], dtype=torch.int32))
    a = tsampling.sample_tokens(logits, *args)
    b = tsampling.sample_tokens(logits, *args)
    assert a.tolist() == b.tolist()
    assert a[0] == torch.argmax(logits[0])
    assert a[1] == a[2]                    # same (seed, position)
    top5 = torch.topk(logits[1], 5).indices.tolist()
    assert int(a[1]) in top5
