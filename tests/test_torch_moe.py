"""The port's MoE against the JAX package: ``moe_ffn`` and its routing,
``moe_aux_loss``, llama4's interleave of dense and MoE layers, and the
reference executor's layer slicing on an interleaved stack.

``moe_ffn`` runs on the same x (numpy draws, skewed toward one expert so
that it overflows) with weights bridged from the reference's
``init_params``, at capacity factor 1.25, where assignments are dropped,
and at 8.0, where none are: outputs agree within the reference's rtol 3e-4
/ atol 5e-4 (f32), and the port's ``moe_route`` drops exactly the
assignments that the reference's arithmetic (``repro/models/
transformer.py:219-229``, repeated here with JAX's own ops) drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving.executor import PagedExecutor as JPagedExecutor
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.models import transformer as ttfm

TOL = dict(rtol=3e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def moe_layer(arch):
    """(jcfg, tcfg, JAX layer-0 MoE params, torch copy) of a tiny MoE
    arch."""
    jcfg, tcfg = jconfigs.get_tiny_config(arch), tconfigs.get_tiny_config(
        arch)
    layers = jtfm.init_params(jcfg, jax.random.PRNGKey(0))["layers"]
    jp = {k: v[0] for k, v in layers.items() if k.endswith(("_e", "_s")) or
          k == "router"}
    return jcfg, tcfg, jp, bridge.params_from_jax(_np(jp), device="cpu")


def skewed_x(jp, n_tok, seed):
    """(2, n_tok, d) rows pulled toward router column 0, so expert 0 is
    in every token's top k and overflows at the default capacity."""
    rng = np.random.default_rng(seed)
    router = np.asarray(jp["router"])
    d = router.shape[0]
    x = rng.standard_normal((2, n_tok, d)).astype(np.float32)
    pull = router[:, 0] / np.linalg.norm(router[:, 0])
    return x + 40.0 * pull.astype(np.float32)


def jax_valid(jp, x, jcfg, cf):
    """Which (token, k) assignments the reference keeps: its routing
    arithmetic, step for step, in JAX."""
    xf = x.reshape(-1, x.shape[-1])
    t, E, k = xf.shape[0], jcfg.num_experts, jcfg.num_experts_per_tok
    probs = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    cap = int(max(8, ((t * k / E) * cf + 7) // 8 * 8))
    flat_e = idx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), 0) - 1
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(pos < cap), np.asarray(flat_e), cap


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_moe_ffn_matches_jax_and_drops_the_same_rows(arch, cf):
    jcfg, tcfg, jp, tp = moe_layer(arch)
    x = skewed_x(jp, 24, seed=3)
    want = np.asarray(jtfm.moe_ffn(jp, jnp.asarray(x), jcfg,
                                   capacity_factor=cf))
    got = ttfm.moe_ffn(tp, torch.from_numpy(x), tcfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jvalid, jexp, jcap = jax_valid(jp, jnp.asarray(x), jcfg, cf)
    gates, dest, valid, cap = ttfm.moe_route(
        tp, torch.from_numpy(x).reshape(-1, x.shape[-1]), tcfg, cf)
    assert cap == jcap
    assert np.array_equal(valid.numpy(), jvalid)
    E = tcfg.num_experts
    kept = valid.numpy()
    assert np.array_equal(dest.numpy()[kept] // cap, jexp[kept])
    assert np.all(dest.numpy()[~kept] == E * cap)
    if cf == 1.25:
        assert not kept.all()           # the skew overflows expert 0
    else:
        assert kept.all()


def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` keeps the lower index among equal values; so
    does the port's routing, on exactly tied router probabilities."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    for k in (1, 2, 3):
        _, got = ttfm._top_k(probs, k)
        _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_moe_aux_loss_matches_jax(arch):
    jcfg, tcfg, jp, tp = moe_layer(arch)
    x = np.random.default_rng(4).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    want = float(jtfm.moe_aux_loss(jp, jnp.asarray(x), jcfg))
    got = float(ttfm.moe_aux_loss(tp, torch.from_numpy(x), tcfg))
    assert got == pytest.approx(want, rel=1e-5)
    assert got >= 1.0 - 1e-3      # >= 1 by Cauchy-Schwarz at balance


def _interleaved_cfgs():
    """``tests/test_models.py::test_moe_interleaved_parity``'s config on
    both sides: 2 layers, 4 experts top-1, interleave 2 with a shared
    expert, capacity factor 8 (dropless)."""
    kw = dict(name="t", family="moe", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=97, dtype="float32",
              remat=False, num_experts=4, num_experts_per_tok=1,
              moe_interleave=2, moe_shared_expert=True,
              moe_capacity_factor=8.0)
    return (JModelConfig(**kw, lora=JLoRAConfig(rank=8)),
            ModelConfig(**kw, lora=LoRAConfig(rank=8)))


def test_moe_interleaved_parity():
    """The port of ``test_models.py::test_moe_interleaved_parity``:
    disaggregated prefill of 8 tokens + 4 decode steps against the port's
    own ``forward`` and against the reference's."""
    jcfg, cfg = _interleaved_cfgs()
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), 3)
    params = bridge.params_from_jax(_np(jparams), device="cpu")
    lora = bridge.lora_from_jax(_np(jlora), device="cpu")
    tokens = np.random.default_rng(2).integers(0, 97, (2, 12))
    ids = [0, 2]
    want = np.asarray(jtfm.forward(
        jparams, jnp.asarray(tokens), jcfg, lora=jlora,
        adapter_ids=jnp.asarray(ids), disagg=True))
    kw = dict(lora=lora, adapter_ids=torch.tensor(ids), disagg=True)
    tok = torch.from_numpy(tokens)
    ref = ttfm.forward(params, tok, cfg, **kw).numpy()
    np.testing.assert_allclose(ref, want, **TOL)
    cache = ttfm.init_cache(cfg, 2, 32, disagg=True, device="cpu")
    lg, cache = ttfm.prefill(params, tok[:, :8], cache, cfg, **kw)
    np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, 7], **TOL)
    kv_len = torch.full((2,), 8, dtype=torch.int32)
    for t in range(8, 12):
        lg, cache = ttfm.decode_step(params, tok[:, t], cache, kv_len, cfg,
                                     **kw)
        np.testing.assert_allclose(lg.numpy(), ref[:, t], **TOL)
        kv_len = kv_len + 1


def test_layer_params_follows_the_interleave():
    """llama4's schedule (``moe_interleave`` 2): layer 2g runs dense MLP g
    and layer 2g + 1 MoE layer g, each with its own attention; dbrx
    (interleave 1) slices every leaf at the layer."""
    _, cfg = _interleaved_cfgs()
    cfg = dataclasses.replace(cfg, num_layers=6)
    params = ttfm.init_params(cfg, 0, device="cpu")
    layers = params["layers"]
    assert layers["router"].shape[0] == 3 and layers["w_up"].shape[0] == 3
    for li in range(6):
        p_l = ttfm.layer_params(params, cfg, li)
        assert torch.equal(p_l["wq"], layers["wq"][li])
        g = li // 2
        if li % 2:
            assert "w_up" not in p_l
            assert torch.equal(p_l["router"], layers["router"][g])
            assert torch.equal(p_l["w_down_s"], layers["w_down_s"][g])
        else:
            assert "router" not in p_l
            assert torch.equal(p_l["w_up"], layers["w_up"][g])
    dbrx = tconfigs.get_tiny_config("dbrx-132b")
    dp = ttfm.init_params(dbrx, 0, device="cpu")
    assert torch.equal(ttfm.layer_params(dp, dbrx, 1)["router"],
                       dp["layers"]["router"][1])


def test_reference_executor_clamps_interleaved_layers():
    """Why the port's llama4 serve is held against the reference's model
    and not its server: the reference ``PagedExecutor._layer_params(li)``
    slices every leaf at ``li``, and JAX clamps an index past a leaf's end,
    so on llama4-tiny (2 layers, one MoE layer) layer 1 gets MoE layer 0's
    router (the only one) and layer 0 the MoE keys too, while the model's
    own schedule runs layer 0 as a dense MLP.  The port's executor follows
    the model (``transformer.layer_params``)."""
    jcfg = jconfigs.get_tiny_config("llama4-maverick-400b-a17b")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    ex = JPagedExecutor(jcfg, jparams, None, JServeConfig(max_pages=8),
                        disagg=False, max_pages_per_req=4)
    router = np.asarray(jparams["layers"]["router"])
    assert router.shape[0] == 1
    np.testing.assert_array_equal(np.asarray(ex._layer_params(1)["router"]),
                                  router[0])
    assert "router" in ex._layer_params(0)          # layer 0 as MoE too
    tcfg = tconfigs.get_tiny_config("llama4-maverick-400b-a17b")
    tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    p0 = ttfm.layer_params(tparams, tcfg, 0)
    assert "router" not in p0 and "w_up" in p0       # dense in the model
    assert "router" in ttfm.layer_params(tparams, tcfg, 1)
