"""The transformer family of the model zoo in the port against the JAX
package: the seven ``transformer.py`` archs of the assignment at their
``tiny()`` sizes, the config registry, and the bridge.

For each of starcoder2 (GELU MLP), internlm2, h2o-danube (sliding window),
llama3-405b, dbrx (MoE top-2), llama4-maverick (MoE top-1, interleaved with
dense layers, shared expert) and llava-next (patch embeddings through
``mm_projector`` before the tokens), weights come from the reference's
``init_params`` / ``init_lora_stacks`` and cross to torch through
``repro_torch.bridge``; tokens and patch embeddings are numpy draws from a
seed.  ``forward`` (no LoRA, unified LoRA, disaggregated LoRA) and
``prefill`` + 5 ``decode_step`` s (unified and disaggregated, the danube
ring wrapping) are held to JAX's logits at the reference's tolerance
(``tests/test_models.py``: rtol 3e-4, atol 5e-4, f32).  Each JAX result is
computed once per module.  Also: ports of ``tests/test_archs.py``'s
serve-step smoke for the seven archs and of its assignment table for all
ten, every config field for field, ``input_specs`` against the
reference's 33 applicable pairs, the registry over every config, the serve
step also for mamba2 and whisper, and the bridge's round trip of every
family's keys, the SSM's and the encoder-decoder's included.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jenc
from repro.models import hybrid as jhyb
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import config as tcore
from repro_torch.models import registry
from repro_torch.models import transformer as ttfm

TOL = dict(rtol=3e-4, atol=5e-4)
B, S, SPLIT, MAX_LEN = 2, 24, 19, 48
ARCHS = ("starcoder2-3b", "internlm2-1.8b", "h2o-danube-3-4b", "llama3-405b",
         "dbrx-132b", "llama4-maverick-400b-a17b", "llava-next-mistral-7b")
IDS = [0, 3]
# the families the model API serves beyond the transformer's: the serve
# step runs over these too
SERVE_ARCHS = ARCHS + ("mamba2-130m", "whisper-large-v3")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# the reference's model API, jitted once per config and setting: eagerly,
# its layer scan compiles again at every call
_JIT = dict(static_argnums=(2,), static_argnames=("disagg",))
j_forward = jax.jit(jtfm.forward, **_JIT)
j_prefill = jax.jit(jtfm.prefill, static_argnums=(3,),
                    static_argnames=("disagg",))
j_decode = jax.jit(jtfm.decode_step, static_argnums=(4,),
                   static_argnames=("disagg",))


@functools.lru_cache(maxsize=None)
def model(arch):
    """(jcfg, jparams, jlora, tcfg, tparams, tlora, tokens, extra) of one
    arch's tiny config; ``extra`` is None except for the VLM."""
    jcfg, tcfg = jconfigs.get_tiny_config(arch), tconfigs.get_tiny_config(
        arch)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), 4)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    extra = None
    if jcfg.frontend == "vision_stub":
        extra = (rng.standard_normal((B, jcfg.num_patches, jcfg.d_model)) *
                 0.5).astype(np.float32)
    return (jcfg, jparams, jlora, tcfg,
            bridge.params_from_jax(_np(jparams), device="cpu"),
            bridge.lora_from_jax(_np(jlora), device="cpu"), tokens, extra)


def _kw(setting, jlora, tlora):
    """(JAX kwargs, torch kwargs) of a LoRA setting."""
    if setting == "no_lora":
        return {}, {}
    disagg = setting == "disagg"
    return (dict(lora=jlora, adapter_ids=jnp.asarray(IDS), disagg=disagg),
            dict(lora=tlora, adapter_ids=torch.tensor(IDS), disagg=disagg))


@functools.lru_cache(maxsize=None)
def jax_forward(arch, setting):
    jcfg, jparams, jlora, _, _, tlora, tokens, extra = model(arch)
    jkw, _ = _kw(setting, jlora, tlora)
    if extra is not None:
        jkw["extra_embeds"] = jnp.asarray(extra)
    return np.asarray(j_forward(jparams, jnp.asarray(tokens), jcfg, **jkw))


def _torch_extra(extra):
    return {} if extra is None else {"extra_embeds": torch.from_numpy(extra)}


@pytest.mark.parametrize("setting", ["no_lora", "unified", "disagg"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, setting):
    jcfg, _, jlora, tcfg, tparams, tlora, tokens, extra = model(arch)
    _, tkw = _kw(setting, jlora, tlora)
    got = ttfm.forward(tparams, torch.from_numpy(tokens).long(), tcfg,
                       **tkw, **_torch_extra(extra))
    want = jax_forward(arch, setting)
    n_patch = jcfg.num_patches if extra is not None else 0
    assert got.shape == want.shape == (B, S + n_patch, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@functools.lru_cache(maxsize=None)
def jax_prefill_decode(arch, setting):
    """The reference's prefill of SPLIT tokens, then decode steps to S:
    logits (B, S - SPLIT + 1, V)."""
    jcfg, jparams, jlora, _, _, tlora, tokens, extra = model(arch)
    jkw, _ = _kw(setting, jlora, tlora)
    cache = jtfm.init_cache(jcfg, B, MAX_LEN, disagg=setting == "disagg",
                            dtype=jnp.float32)
    pkw = {} if extra is None else {"extra_embeds": jnp.asarray(extra)}
    lg, cache = j_prefill(jparams, jnp.asarray(tokens[:, :SPLIT]), cache,
                          jcfg, **jkw, **pkw)
    out = [np.asarray(lg[:, 0])]
    off = jcfg.num_patches if extra is not None else 0
    kv_len = jnp.full((B,), SPLIT + off, jnp.int32)
    for t in range(SPLIT, S):
        lg, cache = j_decode(jparams, jnp.asarray(tokens[:, t]), cache,
                             kv_len, jcfg, **jkw)
        out.append(np.asarray(lg))
        kv_len = kv_len + 1
    return np.stack(out, 1)


@pytest.mark.parametrize("setting", ["unified", "disagg"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax(arch, setting):
    """``prefill`` + 5 ``decode_step`` s with LoRA against the reference's
    (the danube-tiny ring of 16 slots wraps; llava's positions run over its
    8 patches first), and against the port's own ``forward``."""
    jcfg, _, jlora, tcfg, tparams, tlora, tokens, extra = model(arch)
    _, tkw = _kw(setting, jlora, tlora)
    tok = torch.from_numpy(tokens).long()
    cache = ttfm.init_cache(tcfg, B, MAX_LEN, disagg=setting == "disagg",
                            device="cpu")
    lg, cache = ttfm.prefill(tparams, tok[:, :SPLIT], cache, tcfg, **tkw,
                             **_torch_extra(extra))
    got = [lg[:, 0]]
    off = jcfg.num_patches if extra is not None else 0
    kv_len = torch.full((B,), SPLIT + off, dtype=torch.int32)
    for t in range(SPLIT, S):
        lg, cache = ttfm.decode_step(tparams, tok[:, t], cache, kv_len, tcfg,
                                     **tkw)
        got.append(lg)
        kv_len = kv_len + 1
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, jax_prefill_decode(arch, setting), **TOL)
    np.testing.assert_allclose(got, jax_forward(arch, setting)[
        :, off + SPLIT - 1:off + S], **TOL)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_smoke_serve_step(arch):
    """``tests/test_archs.py::test_smoke_serve_step`` through the port's
    registry: one prefill (whisper's with its frame embeddings) and decode
    step against a small cache, disaggregated where the family supports
    ForkKV (mamba2 has no LoRA stacks), shapes and finiteness."""
    cfg = tconfigs.get_tiny_config(arch)
    api = registry.get_model(cfg)
    assert api.supports_forkkv == (cfg.family != "ssm")
    params = api.init_params(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    kw = {}
    if api.init_lora_stacks is not None:
        kw = dict(lora=api.init_lora_stacks(2, 4, device="cpu"),
                  adapter_ids=torch.tensor([0, 3]), disagg=True)
    extra = {}
    if cfg.frontend == "audio_stub":
        extra["extra_embeds"] = torch.from_numpy(
            np.random.default_rng(2).standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    cache = api.init_cache(2, 32, disagg=api.supports_forkkv, device="cpu")
    logits, cache = api.prefill(params, tokens, cache, **kw, **extra)
    assert logits.shape[0] == 2 and logits.shape[-1] == cfg.vocab_size
    step, cache = api.decode_step(params, tokens[:, -1], cache,
                                  torch.full((2,), 16, dtype=torch.int32),
                                  **kw)
    assert step.shape == (2, cfg.vocab_size)
    assert torch.isfinite(step).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_keys_and_shapes(arch):
    """The port's own draws carry the reference's pytree: the same keys
    and shapes (MoE stacks, no ``w_gate`` for the GELU MLP, the projector
    of the vision stub)."""
    jcfg, jparams, _, tcfg, _, _, _, _ = model(arch)
    got = ttfm.init_params(tcfg, 0, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    have = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert have == want


def test_full_configs_match_assignment():
    """``tests/test_archs.py::test_full_configs_match_assignment`` on the
    port's registry: the full configs carry the assigned hyperparameters."""
    spec = {
        "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "llava-next-mistral-7b": (32, 4096, 32, 8, 14336, 32000),
        "llama4-maverick-400b-a17b": (48, 5120, 40, 8, 8192, 202048),
        "h2o-danube-3-4b": (24, 3840, 32, 8, 10240, 32000),
        "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
        "mamba2-130m": (24, 768, 0, 0, 0, 50280),
        "internlm2-1.8b": (24, 2048, 16, 8, 8192, 92544),
        "llama3-405b": (126, 16384, 128, 8, 53248, 128256),
        "whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
    }
    assert set(spec) == set(tconfigs.ARCH_IDS)
    for arch, (L, d, h, kv, ff, v) in spec.items():
        c = tconfigs.get_config(arch)
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
                c.d_ff, c.vocab_size) == (L, d, h, kv, ff, v), arch
    assert tconfigs.get_config("dbrx-132b").num_experts == 16
    assert tconfigs.get_config("dbrx-132b").num_experts_per_tok == 4
    assert tconfigs.get_config("llama4-maverick-400b-a17b").num_experts == 128
    assert tconfigs.get_config(
        "llama4-maverick-400b-a17b").num_experts_per_tok == 1
    assert tconfigs.get_config("mamba2-130m").ssm_state == 128
    assert tconfigs.get_config("h2o-danube-3-4b").resolved_head_dim == 120


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + ("llama3-8b",))
def test_get_model_builds_every_config(arch):
    """``registry.get_model`` builds the API of each of the repo's 11
    configs (the ten archs and the paper's Llama3-8B), at full size (no
    weights are drawn), with the reference's ``supports_forkkv``."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    cfg = LLAMA3_8B if arch == "llama3-8b" else tconfigs.get_config(arch)
    api = registry.get_model(cfg)
    assert api.cfg is cfg
    assert api.supports_forkkv == (cfg.family != "ssm")
    assert (api.init_lora_stacks is None) == (cfg.family == "ssm")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_jax_field_for_field(arch):
    """Every arch's ``CONFIG`` and ``tiny()`` equal the reference's, field
    for field, with the same parameter counts."""
    for get in ("get_config", "get_tiny_config"):
        want, got = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_params == want.num_params
        assert got.active_params == want.active_params
        assert str(got.activation_dtype).split(".")[-1] == \
            jnp.dtype(want.activation_dtype).name


def test_registry_tables_match_jax():
    assert tconfigs.ARCH_MODULES == jconfigs.ARCH_MODULES
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SUB_QUADRATIC == jconfigs.SUB_QUADRATIC
    assert tconfigs.applicable_pairs() == jconfigs.applicable_pairs()
    assert len(tconfigs.applicable_pairs()) == 33
    assert [dataclasses.asdict(s) for s in tcore.INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.INPUT_SHAPES]
    assert tcore.shape_by_name("decode_32k").is_decode
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")
    with pytest.raises(KeyError):
        tcore.shape_by_name("train_8k")


@pytest.mark.parametrize("arch,shape", jconfigs.applicable_pairs())
def test_input_specs_match_jax(arch, shape):
    """``input_specs`` of every applicable pair: the reference's names,
    shapes and dtypes, as ``meta`` tensors that hold no memory."""
    cfg = tconfigs.get_config(arch)
    got = tconfigs.input_specs(cfg, tcore.shape_by_name(shape))
    want = jconfigs.input_specs(jconfigs.get_config(arch),
                                jconfigs.shape_by_name(shape))
    assert list(got) == list(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert got[name].device.type == "meta"
        assert str(got[name].dtype).split(".")[-1] == \
            jnp.dtype(spec.dtype).name, name


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "dbrx-132b"])
def test_concrete_inputs_follow_the_specs(arch):
    cfg = tconfigs.get_tiny_config(arch)
    for shape in tcore.INPUT_SHAPES:
        small = tcore.ShapeConfig(shape.name, 8, 2, shape.mode)
        specs = tconfigs.input_specs(cfg, small)
        got = tconfigs.concrete_inputs(cfg, small, seed=3, device="cpu")
        again = tconfigs.concrete_inputs(cfg, small, seed=3, device="cpu")
        assert list(got) == list(specs)
        for name, t in got.items():
            assert t.shape == specs[name].shape
            assert t.dtype == specs[name].dtype
            assert torch.equal(t, again[name])
            if name == "kv_len":
                assert torch.all(t == 7)
            elif not t.dtype.is_floating_point:
                assert 0 <= t.min() and t.max() < cfg.vocab_size


@functools.lru_cache(maxsize=None)
def _family_params(family):
    """A reference pytree of each family the port serves, by its keys:
    dense SiLU, dense GELU, MoE, interleaved MoE with a shared expert, the
    VLM (with ``mm_projector``), the hybrid (a list of layer dicts), the
    SSM (no LoRA stacks: an empty tree) and the audio encoder-decoder
    (encoder and decoder stacks, LoRA over the decoder)."""
    arch = {"dense": "llama3-405b", "gelu": "starcoder2-3b",
            "moe": "dbrx-132b", "interleaved": "llama4-maverick-400b-a17b",
            "vlm": "llava-next-mistral-7b"}.get(family)
    if arch:
        return model(arch)[1:3]
    if family == "ssm":
        cfg = jconfigs.get_tiny_config("mamba2-130m")
        return jssm.init_params(cfg, jax.random.PRNGKey(0)), {}
    if family == "audio":
        cfg = jconfigs.get_tiny_config("whisper-large-v3")
        return (jenc.init_params(cfg, jax.random.PRNGKey(0)),
                jtfm.init_lora_stacks(cfg, jax.random.PRNGKey(1), 2))
    cfg = jconfigs.get_tiny_config("recurrentgemma-9b")
    return (jhyb.init_params(cfg, jax.random.PRNGKey(0)),
            jhyb.init_lora_stacks(cfg, jax.random.PRNGKey(1), 2))


@pytest.mark.parametrize("family", ["dense", "gelu", "moe", "interleaved",
                                    "vlm", "hybrid", "ssm", "audio"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_every_familys_keys(family, dtype):
    """params/lora -> torch -> numpy, bit for bit, every key kept (bf16
    through its 16-bit pattern)."""
    params, lora = (jax.tree_util.tree_map(
        lambda t: np.asarray(t.astype(dtype)), x)
        for x in _family_params(family))
    for tree, conv in ((params, bridge.params_from_jax),
                       (lora, bridge.lora_from_jax)):
        back = jax.tree_util.tree_map(bridge.tensor_to_numpy,
                                      conv(tree, device="cpu"))
        want, want_def = jax.tree_util.tree_flatten_with_path(tree)
        got, got_def = jax.tree_util.tree_flatten_with_path(back)
        assert want_def == got_def
        for (path, a), (_, b) in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()


@pytest.mark.parametrize("rank", [65, 128, 256])
def test_card_geometry_takes_head_dim_120_and_rank_64_and_refuses_65(rank):
    """h2o-danube-3-4b's head_dim 120 runs the paged kernels: the wrappers'
    ``check_heads`` and the executor's card geometry take it (Hq 32 over
    Hkv 8 at page 16, as the full config serves), in forkkv and in prefix
    mode; a LoRA rank of 64 (the kernels' RP 64 instances) is taken, and
    so is a rank above 64 (their chunked instances: a rank of 65 was
    refused before they existed); a rank of 0 is refused, before any CUDA
    call, naming the rank; on the CPU the plain versions serve head_dim
    120 at the rank."""
    from repro_torch.kernels import paged_residual_attention as tpra
    from repro_torch.kernels import residual_attention as tra
    from repro_torch.serving.api import ForkServer
    from repro_torch.serving.executor import PagedExecutor, \
        check_card_geometry

    full = tconfigs.get_config("h2o-danube-3-4b")
    sc = tcore.ServeConfig(max_pages=16, max_pages_per_req=8)
    assert tpra.check_heads(full.num_heads, full.num_kv_heads,
                            full.resolved_head_dim, sc.page_size) == 4
    for disagg in (True, False):
        check_card_geometry(full, sc, disagg)
    assert tra.RANK_CHUNK == 64
    for r in (33, 64, rank):
        check_card_geometry(dataclasses.replace(
            full, lora=tcore.LoRAConfig(rank=r)), sc, True)
    assert tra.rank_chunked(rank) and not tra.rank_chunked(64)
    zero = dataclasses.replace(full, lora=tcore.LoRAConfig(rank=0))
    check_card_geometry(zero, sc, False)     # prefix mode: no residual
    with pytest.raises(ValueError, match="rank 0"):
        check_card_geometry(zero, sc, True)
    cfg = dataclasses.replace(tconfigs.get_tiny_config("h2o-danube-3-4b"),
                              head_dim=120, lora=tcore.LoRAConfig(rank=rank))
    params = ttfm.init_params(cfg, 0, device="cpu")
    lora = ttfm.init_lora_stacks(cfg, 1, 2, device="cpu")
    bad = dataclasses.replace(cfg, lora=tcore.LoRAConfig(rank=0))
    with pytest.raises(ValueError, match="rank 0"):
        PagedExecutor(bad, params, lora, sc, disagg=True,
                      max_pages_per_req=8, device="cuda")
    ForkServer(cfg, params, lora, sc, device="cpu")
