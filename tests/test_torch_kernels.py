"""The port's plain paged-attention versions against the JAX package.

For the four kernels of the unified prefill/decode grid (mixed and decode,
disaggregated and base-only), the same numpy inputs go through
``repro_torch.kernels.ops`` on the CPU (which takes the plain PyTorch
versions) and through

* ``repro.kernels.ref`` — atol/rtol 1e-5 in f32: both sides materialise
  K/V and take the softmax in one shot;
* the Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs
  them — atol 1e-4: online softmax and the kernels' in-kernel f32 RoPE sum
  in another order.

Covers MHA, GQA and MQA, a window that straddles a page, ragged kv_len,
mid-page chunk starts, and q_len=0 rows, which must be exact zeros.  The
CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import paged_residual_attention as pallas
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_residual_attention as tpra
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

PAGE = 8
POOL = 16
# (hq, hkv, d, r, window): the window of 11 straddles the 8-token pages
ARCHS = {
    "mha": (4, 4, 16, 8, 0),
    "gqa": (8, 2, 32, 8, 0),
    "mqa": (4, 1, 16, 8, 0),
    "swa": (4, 2, 16, 8, 11),
}
# mixed rows: a chunk starting mid-page, a decode row, a q_len=0 padding
# row, a full chunk from position 0
MIXED_START = [5, 20, 0, 0]
MIXED_QLEN = [7, 1, 0, 8]
SQ = 8
# decode rows: ragged kv_len across page boundaries
DECODE_KVLEN = [1, 9, 17, 24]
WIDTH = 4


def make_inputs(arch, seed=0):
    hq, hkv, d, r, window = ARCHS[arch]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = 4
    inp = dict(
        kb=f(POOL, PAGE, hkv, d), vb=f(POOL, PAGE, hkv, d),
        kr=f(POOL, PAGE, r) * 0.3, vr=f(POOL, PAGE, r) * 0.3,
        b_k=f(bsz, r, hkv * d) * 0.3, b_v=f(bsz, r, hkv * d) * 0.3,
        q_mixed=f(bsz, SQ, hq, d), q_decode=f(bsz, hq, d),
        bt_b=np.stack([rng.permutation(POOL)[:WIDTH] for _ in range(bsz)]
                      ).astype(np.int32),
        bt_r=np.stack([rng.permutation(POOL)[:WIDTH] for _ in range(bsz)]
                      ).astype(np.int32),
        start=np.asarray(MIXED_START, np.int32),
        q_len=np.asarray(MIXED_QLEN, np.int32),
        kv_len_mixed=np.asarray(MIXED_START, np.int32) +
        np.asarray(MIXED_QLEN, np.int32),
        kv_len_decode=np.asarray(DECODE_KVLEN, np.int32))
    return inp, window, d ** -0.5


def _args(inp, variant, to):
    """Positional args of the dispatcher for ``variant`` ('mixed' /
    'decode', with '_base' for the base-only twin), converted by ``to``."""
    base = variant.endswith("_base")
    kind = variant.replace("_base", "")
    res = [None] * 4 if base else [to(inp[k]) for k in ("kr", "vr", "b_k",
                                                        "b_v")]
    bt_r = None if base else to(inp["bt_r"])
    head = [to(inp[f"q_{kind}"]), to(inp["kb"]), to(inp["vb"]), *res,
            to(inp["bt_b"]), bt_r]
    if kind == "mixed":
        return head + [to(inp["start"]), to(inp["q_len"]),
                       to(inp["kv_len_mixed"])]
    return head + [to(inp["kv_len_decode"])]


def run_port(inp, variant, window, scale):
    args = _args(inp, variant, torch.from_numpy)
    fn = tops.paged_residual_attention_mixed if variant.startswith("mixed") \
        else tops.paged_residual_attention
    return fn(*args, scale=scale, window=window).numpy()


def run_jax_ref(inp, variant, window, scale):
    args = _args(inp, variant, np.asarray)
    fn = jref.paged_residual_attention_mixed_ref \
        if variant.startswith("mixed") else jref.paged_residual_attention_ref
    return np.asarray(fn(*args, scale=scale, window=window))


def run_pallas(inp, variant, window, scale):
    args = _args(inp, variant, np.asarray)
    kw = dict(scale=scale, window=window, interpret=True)
    if variant == "mixed":
        return np.asarray(pallas.paged_residual_attention_mixed(*args, **kw))
    if variant == "decode":
        return np.asarray(pallas.paged_residual_attention_decode(*args,
                                                                 **kw))
    q, kb, vb, _, _, _, _, bt_b, _, *rest = args
    if variant == "mixed_base":
        return np.asarray(pallas.paged_attention_mixed_base(
            q, kb, vb, bt_b, *rest, **kw))
    return np.asarray(pallas.paged_attention_decode_base(q, kb, vb, bt_b,
                                                         *rest, **kw))


VARIANTS = ["mixed", "decode", "mixed_base", "decode_base"]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_jax_ref(variant, arch):
    inp, window, scale = make_inputs(arch)
    got = run_port(inp, variant, window, scale)
    want = run_jax_ref(inp, variant, window, scale)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_interpret(variant, arch):
    inp, window, scale = make_inputs(arch)
    got = run_port(inp, variant, window, scale)
    want = run_pallas(inp, variant, window, scale)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("base", [False, True])
def test_prefill_plain_matches_jax_ref(base, arch):
    """The phase-separated prefill's plain version (its kernel, Pallas #5 /
    #6, is ported later) against ``repro.kernels.ref``."""
    inp, window, scale = make_inputs(arch)

    def args(to):
        a = _args(inp, "mixed_base" if base else "mixed", to)
        return a[:-2] + [a[-1]]           # (..., start, kv_len): no q_len

    got = tref.paged_residual_attention_prefill_ref(
        *args(torch.from_numpy), scale=scale, window=window).numpy()
    want = np.asarray(jref.paged_residual_attention_prefill_ref(
        *args(np.asarray), scale=scale, window=window))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["mixed", "mixed_base"])
def test_rows_past_q_len_are_exact_zeros(variant):
    inp, window, scale = make_inputs("gqa")
    got = run_port(inp, variant, window, scale)
    for b, ql in enumerate(MIXED_QLEN):
        assert np.all(got[b, ql:] == 0.0)
        assert np.all(np.isfinite(got[b, :ql]))
    assert np.all(got[2] == 0.0)          # the q_len=0 padding row


def test_dispatch_counts_plain_versions():
    inp, window, scale = make_inputs("gqa")
    before = dict(tref.LAUNCHES)
    run_port(inp, "mixed", window, scale)
    run_port(inp, "decode_base", window, scale)
    assert tref.LAUNCHES["paged_residual_attention_mixed_ref"] == \
        before["paged_residual_attention_mixed_ref"] + 1
    assert tref.LAUNCHES["paged_residual_attention_ref"] == \
        before["paged_residual_attention_ref"] + 1


def test_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper of a CUDA kernel never falls back to the plain version:
    handed CPU tensors it raises, and counts no launch."""
    inp, window, scale = make_inputs("gqa")
    args = _args(inp, "mixed", torch.from_numpy)
    before = dict(tpra.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tpra.paged_residual_attention_mixed(*args, scale=scale)
    assert tpra.LAUNCHES == before
