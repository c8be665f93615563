"""The port's ``ForkServer`` on the MoE and GELU archs of the zoo against
the JAX package.

dbrx-tiny (MoE top-2 on every layer) and starcoder2-tiny (GELU MLP, a
group of 2) serve ``tests/test_torch_serving.py``'s staggered workload
(copied here) in forkkv and prefix mode under the mixed loop, on the
reference's bridged f32 weights: greedy tokens equal the reference
``ForkServer``'s.  llama4-tiny (MoE interleaved with dense layers) is held
to the reference's *model* instead: the reference executor slices every
parameter leaf at the layer index, which JAX clamps, so its server runs
the MoE sublayer on every layer and never the dense one
(``test_reference_executor_clamps_interleaved_layers`` in
``tests/test_torch_moe.py``);
the port's server follows the model's schedule, and its prefix-mode forks
equal greedy ``prefill`` + ``decode_step`` of the reference model under
each fork's adapter.  The tiny MoE configs' capacity factor of 8 keeps
every assignment, so the batch's padding rows, which route like any
other, drop nothing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving.api import ForkServer as JForkServer
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core.config import ServeConfig as TServeConfig
from repro_torch.kernels import ref as tref
from repro_torch.serving.api import ForkServer as TForkServer
from repro_torch.serving.sampling import SamplingParams as TSamplingParams

PAGE = 16
NEW = 5
# (adapter, instruction length) of the three forks; the third replays the
# first
FORKS = ((1, 5), (2, 6), (1, 5))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def models(arch):
    jcfg = jconfigs.get_tiny_config(arch)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1), n_adapters=4)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ((jcfg, jparams, jlora),
            (tconfigs.get_tiny_config(arch),
             bridge.params_from_jax(to_np(jparams), "cpu"),
             bridge.lora_from_jax(to_np(jlora), "cpu")))


def context(vocab):
    rng = np.random.default_rng(7)
    return [int(t) for t in rng.integers(0, vocab, 40)]


def run_workload(make_server, sc_cls, sp_cls, vocab, mode):
    """``test_torch_serving.run_workload``: one pinned 40-token context,
    two forks (the second submitted while the first decodes, so a plan
    mixes decode and prefill rows), then a replay of the first."""
    sc = sc_cls(page_size=PAGE, max_pages=96, max_batch=4,
                max_prefill_tokens=48, max_pages_per_req=8, mode=mode)
    server = make_server(sc)
    ctx = context(vocab)
    with server.session(ctx, adapter_id=0) as sess:
        (a0, n0), (a1, n1), (a2, n2) = FORKS
        handles = [sess.fork(a0, ctx[:n0], sp_cls(max_new_tokens=NEW))]
        for _ in range(3):       # first fork reaches decode...
            server.poll()
        handles.append(sess.fork(a1, ctx[:n1], sp_cls(max_new_tokens=NEW)))
        outs = [o.tokens for o in server.wait(handles)]
        replay = [sess.fork(a2, ctx[:n2], sp_cls(max_new_tokens=NEW))]
        outs += [o.tokens for o in server.wait(replay)]
    return outs, server.metrics()


def serve_port(tcfg, tparams, tlora, mode):
    before = dict(tref.LAUNCHES)
    outs, m = run_workload(
        lambda sc: TForkServer(tcfg, tparams, tlora, sc, device="cpu"),
        TServeConfig, TSamplingParams, tcfg.vocab_size, mode)
    assert all(len(t) == NEW for t in outs)
    assert m["mixed_steps"] >= 1 and m["fallback_gather_calls"] == 0
    assert m["exec_errors"] == 0 and m["tasks_done"] == 3
    assert tref.LAUNCHES["paged_residual_attention_mixed_ref"] > \
        before["paged_residual_attention_mixed_ref"]
    return outs


@pytest.mark.parametrize("mode", ["forkkv", "prefix"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "starcoder2-3b"])
def test_port_serves_same_greedy_tokens_as_jax(arch, mode):
    (jcfg, jparams, jlora), (tcfg, tparams, tlora) = models(arch)
    jout, _ = run_workload(
        lambda sc: JForkServer(jcfg, jparams, jlora, sc), JServeConfig,
        JSamplingParams, jcfg.vocab_size, mode)
    assert serve_port(tcfg, tparams, tlora, mode) == jout


def test_llama4_serves_the_reference_models_greedy_tokens():
    """Each prefix-mode fork of the interleaved MoE model equals greedy
    decoding of the reference model on context + instruction under the
    fork's adapter (unified LoRA, as prefix mode caches it)."""
    (jcfg, jparams, jlora), (tcfg, tparams, tlora) = models(
        "llama4-maverick-400b-a17b")
    got = serve_port(tcfg, tparams, tlora, "prefix")
    ctx = context(jcfg.vocab_size)
    prefill = jax.jit(jtfm.prefill, static_argnums=(3,))
    decode = jax.jit(jtfm.decode_step, static_argnums=(4,))
    for (adapter, n_instr), tokens in zip(FORKS, got):
        prompt = jnp.asarray([ctx + ctx[:n_instr]], jnp.int32)
        kw = dict(lora=jlora, adapter_ids=jnp.asarray([adapter]))
        cache = jtfm.init_cache(jcfg, 1, 64)
        lg, cache = prefill(jparams, prompt, cache, jcfg, **kw)
        want = [int(jnp.argmax(lg[0, 0]))]
        kv_len = jnp.asarray([prompt.shape[1]], jnp.int32)
        for _ in range(NEW - 1):
            lg, cache = decode(jparams, jnp.asarray(want[-1:], jnp.int32),
                               cache, kv_len, jcfg, **kw)
            want.append(int(jnp.argmax(lg[0])))
            kv_len = kv_len + 1
        assert tokens == want
