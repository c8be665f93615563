"""``tests/test_archs.py``'s forward-and-train step on the port, for every
one of the repo's 11 configs at its tiny size (the ten archs' ``tiny()``
and the paper's Llama3-8B as ``tiny_serving_model()``), against the JAX
package on the same weights (bridged) and tokens (a numpy draw):
``forward``'s logits of the expected shape and finite, and one
``make_train_step`` step with the config's own optimizer and remat
setting, whose loss and ``grad_norm`` equal the reference's to 1e-4
relative (f32).  Then the remat switch: each config's gradients with
``remat`` on and off, equal (the checkpointed layers recompute the same
f32 arithmetic).  Each JAX result is computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import paper_models as jpaper
from repro.models.registry import get_model as jget_model
from repro.training import train_loop as jtl
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.configs import paper_models as tpaper
from repro_torch.models import base as tbase
from repro_torch.models.registry import get_model
from repro_torch.training import train_loop

ARCHS = tuple(jconfigs.ARCH_IDS) + ("llama3-8b",)
B, S = 2, 32
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch):
    if arch == "llama3-8b":
        return jpaper.tiny_serving_model(), tpaper.tiny_serving_model()
    return jconfigs.get_tiny_config(arch), tconfigs.get_tiny_config(arch)


def _batch(cfg):
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "vision_stub":
        batch["extra_embeds"] = np.zeros((B, cfg.num_patches, cfg.d_model),
                                         np.float32)
    if cfg.frontend == "audio_stub":
        batch["extra_embeds"] = np.zeros((B, cfg.encoder_seq, cfg.d_model),
                                         np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_results():
    """Per arch: the reference's weights, forward logits' shape and one
    train step's loss and grad_norm."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        api = jget_model(jcfg)
        params = api.init_params(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
        init, step = jtl.make_train_step(jcfg, lr=1e-3)
        _, _, m = jax.jit(step)(params, init(params), batch)
        out[arch] = dict(params=jax.tree_util.tree_map(np.asarray, params),
                         loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step_match_jax(jax_results, arch):
    _, cfg = _cfgs(arch)
    want = jax_results[arch]
    params = bridge.params_from_jax(want["params"], "cpu")
    batch = _batch(cfg)
    kw = {}
    if "extra_embeds" in batch:
        kw["extra_embeds"] = torch.tensor(batch["extra_embeds"])
    with torch.no_grad():
        logits = get_model(cfg).forward(params,
                                        torch.tensor(batch["tokens"]), **kw)
    seq = S + (cfg.num_patches if cfg.frontend == "vision_stub" else 0)
    assert logits.shape == (B, seq, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    init, step = train_loop.make_train_step(cfg, lr=1e-3, device="cpu")
    _, _, m = step(params, init(params), batch)
    assert float(m["loss"]) > 0
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=REL)
    assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                  rel=REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_equal_gradients(jax_results, arch):
    """The same loss and gradients with every checkpoint unit of the
    config under ``torch.utils.checkpoint`` and without (f32, rtol 1e-6)."""
    _, cfg = _cfgs(arch)
    params = bridge.params_from_jax(jax_results[arch]["params"], "cpu")
    batch = train_loop._to(_batch(cfg), torch.device("cpu"))
    grads = []
    for remat in (False, True):
        api = get_model(dataclasses.replace(cfg, remat=remat))
        value, g = train_loop._value_and_grad(
            lambda p, b: train_loop._loss_fn(api, p, b), params, batch)
        grads.append((value, tbase.leaves(g)))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6,
                               atol=0)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
