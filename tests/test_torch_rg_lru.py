"""The port's RG-LRU scan (Pallas #9) and the dense ResidualAttention plain
version at RecurrentGemma's head_dim 256, against the JAX package.

* ``repro_torch.kernels.ref.rg_lru_scan_ref`` against the Pallas kernel
  ``repro.kernels.rg_lru.rg_lru_scan`` in interpret mode, at
  ``tests/test_kernels.py``'s three cases and tolerances (f32 2e-5, bf16
  2e-2), and against the reference model's own chunked associative scan
  ``repro.models.hybrid._rglru_scan`` (two chunks of 256, and the ragged
  fallback) within 1e-5 in f32: the two sum in another order;
* ``kernels.ops.rg_lru_scan`` on CPU tensors takes the plain version and
  never the kernel, whose wrapper refuses CPU tensors (the kernel runs
  only on the card, in ``chip_smoke.py``);
* the dense plain version at D 256, G 16 (RecurrentGemma-9B's local
  attention is MQA over 16 heads of 256) against
  ``repro.kernels.ref.residual_attention_ref``, and the dense kernels' row
  budget per head_dim.

Inputs are numpy draws from a seed.  No JAX global is touched: the Pallas
function takes ``interpret=True`` as an argument.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import rg_lru as pallas
from repro.models import hybrid as jhyb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_attention as tra
from repro_torch.kernels import rg_lru as trg


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _scan_inputs(bsz, s, w, seed=0):
    """a in (0, 1) as the model's gates give it, b and h0 non-zero."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((bsz, s, w))))
    b = rng.standard_normal((bsz, s, w)) * 0.2
    h0 = rng.standard_normal((bsz, w)) * 0.5
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


# tests/test_kernels.py's cases: (bsz, s, w, block_s, block_w, dtype)
PALLAS_CASES = {
    "f32": (2, 128, 128, 64, 64, "float32"),
    "f32_ragged": (1, 200, 96, 64, 64, "float32"),
    "bf16": (2, 128, 128, 64, 64, "bfloat16"),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_matches_pallas_interpret(case):
    bsz, s, w, bs, bw, dtype = PALLAS_CASES[case]
    a, b, h0 = _scan_inputs(bsz, s, w, seed=len(case))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)
    want, wlast = pallas.rg_lru_scan(
        jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
        jnp.asarray(h0).astype(jdt), block_s=bs, block_w=bw, interpret=True)
    got, glast = tref.rg_lru_scan_ref(_torch(a, tdt), _torch(b, tdt),
                                      _torch(h0, tdt))
    assert got.dtype == tdt and got.shape == (bsz, s, w)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(glast.float().numpy(),
                               np.asarray(wlast, np.float32), **tol)
    assert torch.equal(glast, got[:, -1])


@pytest.mark.parametrize("s", [512, 200])
def test_plain_matches_the_reference_models_scan(s):
    """S 512 runs the reference's two chunks of ``LRU_CHUNK`` 256, S 200
    its direct associative scan over the ragged length."""
    a, b, h0 = _scan_inputs(2, s, 64, seed=s)
    want, wlast = jhyb._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0))
    got, glast = tref.rg_lru_scan_ref(torch.from_numpy(a),
                                      torch.from_numpy(b),
                                      torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(glast.numpy(), np.asarray(wlast), atol=1e-5,
                               rtol=1e-5)


def test_dispatch_on_cpu_takes_the_plain_version():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(3, 17, 40))
    kernel_before = dict(trg.LAUNCHES)
    plain_before = tref.LAUNCHES["rg_lru_scan_ref"]
    got, last = tops.rg_lru_scan(a, b, h0)
    want, _ = tref.rg_lru_scan_ref(a, b, h0)
    assert torch.equal(got, want) and torch.equal(last, got[:, -1])
    assert trg.LAUNCHES == kernel_before == {"rg_lru_scan": 0,
                                              "rg_lru_scan_bwd": 0}
    assert tref.LAUNCHES["rg_lru_scan_ref"] == plain_before + 2


def test_plain_version_at_one_step_is_one_update():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 1, 24))
    got, last = tref.rg_lru_scan_ref(a, b, h0)
    assert torch.equal(got[:, 0], a[:, 0] * h0 + b[:, 0])
    assert torch.equal(last, got[:, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_refuses_cpu_tensors(dtype):
    a, b, h0 = (_torch(x, dtype) for x in _scan_inputs(2, 8, 16))
    before = dict(trg.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        trg.rg_lru_scan(a, b, h0)
    assert trg.LAUNCHES == before


# RecurrentGemma-9B's local attention: Hq 16, Hkv 1, D 256, R 16
HQ, HKV, D, R = 16, 1, 256, 16


def _rope_tables(pos, d):
    inv = 1.0 / (10_000.0 ** (np.arange(d // 2, dtype=np.float32) /
                              (d // 2)))
    ang = pos.astype(np.float32)[..., None] * inv
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def _dense_inputs(bsz, sq, sk, start, kv_len, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sin, cos = _rope_tables(np.broadcast_to(np.arange(sk), (bsz, sk)), D)
    return dict(
        q=f(bsz, sq, HQ, D), k_base=f(bsz, sk, HKV, D),
        v_base=f(bsz, sk, HKV, D), k_res=f(bsz, sk, R) * 0.3,
        v_res=f(bsz, sk, R) * 0.3, b_k=f(bsz, R, HKV * D) * 0.3,
        b_v=f(bsz, R, HKV * D) * 0.3, sin=sin, cos=cos,
        qpos=(np.asarray(start, np.int32)[:, None] +
              np.arange(sq, dtype=np.int32)[None]),
        kv_len=None if kv_len is None else np.asarray(kv_len, np.int32))


_ORDER = ("q", "k_base", "v_base", "k_res", "v_res", "b_k", "b_v", "sin",
          "cos")
# (sq, sk, start, kv_len): a forward (kv_len None), a chunk at an offset
# with ragged kv_len, a ragged decode
DENSE_CASES = {
    "full": (12, 12, [0, 0], None),
    "chunk": (5, 16, [7, 3], [12, 8]),
    "decode": (1, 16, [2, 15, 8], [3, 16, 9]),
}


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_plain_at_head_dim_256_matches_jax_ref(case, window):
    inp = _dense_inputs(len(DENSE_CASES[case][2]), *DENSE_CASES[case])
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in inp.items()}
    got = tops.residual_attention(
        *[t[k] for k in _ORDER], qpos=t["qpos"], kv_len=t["kv_len"],
        window=window, scale=D ** -0.5).numpy()
    want = np.asarray(jref.residual_attention_ref(
        *[jnp.asarray(inp[k]) for k in _ORDER],
        qpos=jnp.asarray(inp["qpos"]),
        kv_len=None if inp["kv_len"] is None else jnp.asarray(inp["kv_len"]),
        window=window, scale=D ** -0.5))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d,group,rows", [
    (64, 8, 64), (128, 4, 64), (128, 64, 64), (256, 16, 32), (256, 32, 32),
    (32, 2, 64),
])
def test_dense_kernels_take_head_dim_256(d, group, rows):
    """Rows per CTA by head_dim: 64 at D <= 128 (as before), 32 at D 256,
    where a query tile of G 16 is 2 positions."""
    assert tra.tile_rows(d, group) == rows


@pytest.mark.parametrize("d,group,match", [
    (96, 4, "head_dim 96"), (48, 4, "head_dim 48"), (512, 1, "head_dim 512"),
    (256, 64, "group size 64 > 32"), (128, 128, "group size 128 > 64"),
])
def test_dense_kernels_refuse_other_head_dims_and_groups(d, group, match):
    with pytest.raises(ValueError, match=match):
        tra.tile_rows(d, group)


def test_dense_wrapper_refuses_cpu_tensors_at_head_dim_256():
    inp = _dense_inputs(2, *DENSE_CASES["chunk"])
    args = [torch.from_numpy(inp[k]) for k in _ORDER]
    before = dict(tra.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tra.residual_attention_prefill(
            *args, torch.from_numpy(inp["qpos"]),
            torch.from_numpy(inp["kv_len"]), scale=D ** -0.5)
    assert tra.LAUNCHES == before


def test_bf16_inputs_cross_bit_for_bit():
    """The bf16 scan inputs above reach both sides with the same bits."""
    a, _, _ = _scan_inputs(1, 4, 8)
    j = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    t = _torch(a, torch.bfloat16)
    assert j.dtype == ml_dtypes.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == j.tobytes()
