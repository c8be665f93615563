"""The gradient of the port's RG-LRU scan against the JAX package.

``kernels.rg_lru.RgLruScan`` is the only route of ``ops.rg_lru_scan``: on
the card its forward and backward launch ``csrc/rg_lru.cu``'s kernels, on
the CPU they run the plain versions ``ref.rg_lru_scan_ref`` and
``ref.rg_lru_scan_bwd_ref`` (the backward's reverse recurrence, one step
at a time with an f32 carry).  Here, on the CPU:

* ``torch.autograd.gradcheck`` of ``RgLruScan`` in f64 (the plain versions
  carry f64 for f64 inputs), both outputs used, and of the
  reverse-recurrence formula directly;
* its gradients against ``jax.vjp`` of the reference's
  ``repro.models.hybrid._rglru_scan`` (a chunked associative scan) on the
  same numpy inputs and cotangents: one chunk, two whole chunks of
  ``LRU_CHUNK``, and a ragged tail (S % LRU_CHUNK != 0, the reference's
  direct associative scan); f32, rtol 1e-4 / atol 1e-5 (the two scans
  combine the products in different orders: ~1e-6 apart);
* a tiny hybrid's parameter gradients of the cross-entropy loss against
  ``jax.grad`` of the reference's, every leaf, f32 at rtol 2e-3 / atol
  2e-5 (the logits agree to ~1e-5 there, tests/test_torch_hybrid.py, and a
  gradient through 4 layers and the vocabulary's softmax sums many such
  terms);
* the hybrid's gradients with remat on and off, equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.models import base as jbase
from repro.models import hybrid as jhyb
from repro_torch import bridge
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.kernels import ops, ref, rg_lru
from repro_torch.models import base as tbase
from repro_torch.models import hybrid as thyb

SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-5)


def _inputs(bsz, s, w, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((bsz, s, w))))).astype(dtype)
    b = (0.2 * rng.standard_normal((bsz, s, w))).astype(dtype)
    h0 = (0.5 * rng.standard_normal((bsz, w))).astype(dtype)
    ds = rng.standard_normal((bsz, s, w)).astype(dtype)
    dh = rng.standard_normal((bsz, w)).astype(dtype)
    return a, b, h0, ds, dh


def test_gradcheck_f64():
    """RgLruScan's backward is the gradient of its forward, f64, with both
    outputs reaching the loss (gradcheck's own tolerances)."""
    a, b, h0, _, _ = _inputs(2, 9, 5, 0, np.float64)
    args = [torch.tensor(x, requires_grad=True) for x in (a, b, h0)]
    assert torch.autograd.gradcheck(
        lambda a, b, h: rg_lru.RgLruScan.apply(a, b, h), args)
    assert torch.autograd.gradcheck(
        lambda a, b, h: ops.rg_lru_scan(a, b, h)[1], args)


@pytest.mark.parametrize("s", [1, 4])
def test_backward_formula_at_short_lengths(s):
    """g_S = dstates_S + dh_last, g_t = dstates_t + a_{t+1} g_{t+1}, db =
    g, da_t = g_t h_{t-1} (h_0 := h0), dh0 = a_1 g_1, written out by hand
    for S 1 and 4 (f64, exact up to rounding)."""
    a, b, h0, ds, dh = (torch.tensor(x) for x in
                        _inputs(1, s, 3, 1, np.float64))
    states, _ = ref.rg_lru_scan_ref(a, b, h0)
    da, db, dh0 = ref.rg_lru_scan_bwd_ref(a, states, h0, ds, dh)
    g = ds[:, -1] + dh
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            g = ds[:, t] + a[:, t + 1] * g
        torch.testing.assert_close(db[:, t], g)
        prev = states[:, t - 1] if t > 0 else h0
        torch.testing.assert_close(da[:, t], g * prev)
    torch.testing.assert_close(dh0, a[:, 0] * g)


@pytest.mark.parametrize("s", [7, 2 * jhyb.LRU_CHUNK, 300])
def test_grads_match_jax_vjp_of_the_reference_scan(s):
    """da, db, dh0 against ``jax.vjp`` of ``_rglru_scan``: S 7 (one chunk),
    S 512 (two chunks) and S 300 (a ragged tail: the reference's direct
    associative scan), f32."""
    a, b, h0, ds, dh = _inputs(2, s, 16, s)
    (want_s, want_h), vjp = jax.vjp(jhyb._rglru_scan, jnp.asarray(a),
                                    jnp.asarray(b), jnp.asarray(h0))
    want = vjp((jnp.asarray(ds), jnp.asarray(dh)))
    ta, tb, th = (torch.tensor(x, requires_grad=True) for x in (a, b, h0))
    got_s, got_h = ops.rg_lru_scan(ta, tb, th)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **SCAN_TOL)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               **SCAN_TOL)
    torch.autograd.backward((got_s, got_h),
                            (torch.tensor(ds), torch.tensor(dh)))
    for got, w in zip((ta.grad, tb.grad, th.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **SCAN_TOL)


def test_bwd_ref_counts_its_calls_and_takes_the_last_state_gradient():
    """The plain backward counts its calls; a gradient on the last state
    alone (dstates 0) flows back as a product of the a_t."""
    a, b, h0, _, dh = (torch.tensor(x) for x in _inputs(1, 6, 4, 2))
    states, _ = ref.rg_lru_scan_ref(a, b, h0)
    before = ref.LAUNCHES["rg_lru_scan_bwd_ref"]
    _, db, dh0 = ref.rg_lru_scan_bwd_ref(a, states, h0,
                                         torch.zeros_like(states), dh)
    assert ref.LAUNCHES["rg_lru_scan_bwd_ref"] == before + 1
    torch.testing.assert_close(db[:, -1], dh)
    torch.testing.assert_close(db[:, 0], dh * a[:, 1:].prod(dim=1))
    torch.testing.assert_close(dh0, dh * a.prod(dim=1))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises: CPU tensors are refused,
    never sent to the plain version."""
    a, b, h0, ds, dh = (torch.tensor(x) for x in _inputs(1, 3, 4, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rg_lru.rg_lru_scan_bwd(a, a, h0, ds, dh)


# ------------------------------------------------------------ tiny hybrid
def _cfgs(remat=False):
    base = dict(name="thyb", family="hybrid", num_layers=4, d_model=64,
                num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=97,
                dtype="float32", block_pattern=("rglru", "rglru", "local"),
                local_window=8, lru_width=64, remat=remat)
    return (JModelConfig(**base, lora=JLoRAConfig(rank=8)),
            ModelConfig(**base, lora=LoRAConfig(rank=8)))


@pytest.fixture(scope="module")
def hybrid_grads():
    """The reference's loss and parameter gradients on a 4-layer hybrid (S
    40, which wraps the local window of 8), and the bridged weights and
    batch."""
    jcfg, tcfg = _cfgs()
    params = jhyb.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)

    def loss(p):
        return jbase.cross_entropy(jhyb.forward(p, jnp.asarray(tokens),
                                                jcfg), jnp.asarray(labels))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params), "cpu")
    return dict(value=float(value), grads=jax.tree_util.tree_map(
        np.asarray, grads), params=tparams, tokens=torch.tensor(tokens),
        labels=torch.tensor(labels, dtype=torch.long), tcfg=tcfg)


def _torch_grads(h, cfg):
    leaves = []

    def track(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    tracked = tbase.tree_map(track, h["params"])
    loss = tbase.cross_entropy(thyb.forward(tracked, h["tokens"], cfg),
                               h["labels"])
    loss.backward()
    return float(loss.detach()), tracked


def test_hybrid_parameter_grads_match_jax(hybrid_grads):
    """Every parameter's gradient of the loss through the tiny hybrid
    (two RG-LRU layers, whose scans take ``RgLruScan``) against
    ``jax.grad`` of the reference's."""
    h = hybrid_grads
    value, tracked = _torch_grads(h, h["tcfg"])
    assert value == pytest.approx(h["value"], rel=1e-5)

    def check(g, t):
        np.testing.assert_allclose(t.grad.numpy(), g, **MODEL_TOL)

    jax.tree_util.tree_map(check, h["grads"], tracked)
    # the first RG-LRU layer's gates get a gradient through the scan
    assert np.abs(tracked["layers"][0]["lam"].grad.numpy()).max() > 0


def test_hybrid_grads_equal_with_remat_on_and_off(hybrid_grads):
    """``cfg.remat`` runs each layer under ``torch.utils.checkpoint``; the
    gradients are the same as without it (f32, recomputed in the same
    order: equal to 1e-6)."""
    h = hybrid_grads
    _, off = _torch_grads(h, h["tcfg"])
    _, on = _torch_grads(h, dataclasses.replace(h["tcfg"], remat=True))
    for a, b in zip(tbase.leaves(off), tbase.leaves(on)):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)
