"""The port's dense ResidualAttention plain version against the JAX package.

For the two dense kernels (Pallas #7 ``residual_attention_prefill`` and #8
``residual_attention_decode``), the same numpy inputs go through
``repro_torch.kernels.ops.residual_attention`` on the CPU (which takes the
plain PyTorch version) and through

* ``repro.kernels.ref.residual_attention_ref`` — atol/rtol 1e-5 in f32:
  both sides materialise K/V and take the softmax in one shot;
* the Pallas kernels, called directly in interpret mode as
  ``tests/test_kernels.py`` calls them — atol 1e-4: online softmax over
  key blocks sums in another order.

Covers MHA, GQA and MQA, window 0 and 5, a chunk at an offset (query
positions past 0 with kv_len < Sk), ``kv_len=None``, Sq and Sk that are
not multiples of Pallas's 128 blocks (padded there, not in the port), and
decode with ragged kv_len.  Every query row sees at least one key: a row
that sees none averages V in the plain versions and is 0 in the kernels.
Also ``mha`` and ``banded_window_attention`` against JAX, and the CUDA
wrappers' refusal of CPU tensors (the kernels run only on the card, in
``chip_smoke.py``).  No JAX global is touched: the Pallas functions take
``interpret=True`` as an argument.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.kernels import ref as jref
from repro.kernels import residual_attention as pallas
from repro_torch.core import attention as tattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_attention as tra


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# (hq, hkv)
HEADS = {"mha": (4, 4), "gqa": (8, 2), "mqa": (4, 1)}
D, R = 16, 8
# (sq, sk, start, kv_len): start is each row's first query position; the
# "full" case is the model's forward (positions 0..S-1, kv_len None); the
# "chunk" case a chunk at an offset with kv_len = start + Sq < Sk
CASES = {
    "full": (12, 12, [0, 0], None),
    "chunk": (5, 16, [7, 3], [12, 8]),
}
DECODE_KVLEN = [3, 16, 9]


def _rope_tables(pos, d):
    inv = 1.0 / (10_000.0 ** (np.arange(d // 2, dtype=np.float32) /
                              (d // 2)))
    ang = pos.astype(np.float32)[..., None] * inv
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def make_inputs(arch, bsz, sq, sk, start, kv_len, seed=0):
    hq, hkv = HEADS[arch]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sin, cos = _rope_tables(np.broadcast_to(np.arange(sk), (bsz, sk)), D)
    return dict(
        q=f(bsz, sq, hq, D), k_base=f(bsz, sk, hkv, D),
        v_base=f(bsz, sk, hkv, D), k_res=f(bsz, sk, R) * 0.3,
        v_res=f(bsz, sk, R) * 0.3, b_k=f(bsz, R, hkv * D) * 0.3,
        b_v=f(bsz, R, hkv * D) * 0.3, sin=sin, cos=cos,
        qpos=(np.asarray(start, np.int32)[:, None] +
              np.arange(sq, dtype=np.int32)[None]),
        kv_len=None if kv_len is None else np.asarray(kv_len, np.int32))


_ORDER = ("q", "k_base", "v_base", "k_res", "v_res", "b_k", "b_v", "sin",
          "cos")


def run_port(inp, window):
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in inp.items()}
    return tops.residual_attention(
        *[t[k] for k in _ORDER], qpos=t["qpos"], kv_len=t["kv_len"],
        window=window, scale=D ** -0.5).numpy()


def run_jax_ref(inp, window):
    return np.asarray(jref.residual_attention_ref(
        *[jnp.asarray(inp[k]) for k in _ORDER], qpos=jnp.asarray(inp["qpos"]),
        kv_len=None if inp["kv_len"] is None else jnp.asarray(inp["kv_len"]),
        window=window, scale=D ** -0.5))


def run_pallas(inp, window):
    """The Pallas kernel the JAX dispatcher would pick (#8 for Sq = 1).
    The Pallas kernels need an explicit kv_len: None means all of Sk."""
    bsz, sk = inp["k_base"].shape[:2]
    kv_len = inp["kv_len"] if inp["kv_len"] is not None else \
        np.full((bsz,), sk, np.int32)
    args = [jnp.asarray(inp[k]) for k in _ORDER]
    if inp["q"].shape[1] == 1:
        args[0] = args[0][:, 0]
        out = pallas.residual_attention_decode(
            *args, jnp.asarray(kv_len), scale=D ** -0.5, window=window,
            interpret=True)
        return np.asarray(out)[:, None]
    return np.asarray(pallas.residual_attention_prefill(
        *args, jnp.asarray(inp["qpos"]), jnp.asarray(kv_len),
        scale=D ** -0.5, window=window, interpret=True))


def _prefill_inputs(arch, case):
    sq, sk, start, kv_len = CASES[case]
    return make_inputs(arch, 2, sq, sk, start, kv_len)


def _decode_inputs(arch):
    kv_len = np.asarray(DECODE_KVLEN, np.int32)
    return make_inputs(arch, len(DECODE_KVLEN), 1, 16, kv_len - 1, kv_len)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("case", list(CASES) + ["decode"])
@pytest.mark.parametrize("arch", list(HEADS))
def test_plain_matches_jax_ref(arch, case, window):
    inp = _decode_inputs(arch) if case == "decode" else \
        _prefill_inputs(arch, case)
    np.testing.assert_allclose(run_port(inp, window), run_jax_ref(inp, window),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("case", list(CASES) + ["decode"])
@pytest.mark.parametrize("arch", list(HEADS))
def test_plain_matches_pallas_interpret(arch, case, window):
    inp = _decode_inputs(arch) if case == "decode" else \
        _prefill_inputs(arch, case)
    np.testing.assert_allclose(run_port(inp, window), run_pallas(inp, window),
                               atol=1e-4, rtol=0)


def test_ragged_sq_and_sk_past_one_block():
    """Sq = Sk = 150: Pallas pads both to 256 (two 128-blocks); the port
    takes them as they are."""
    inp = make_inputs("gqa", 1, 150, 150, [0], [150])
    got = run_port(inp, 0)
    np.testing.assert_allclose(got, run_pallas(inp, 0), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, run_jax_ref(inp, 0), atol=1e-5,
                               rtol=1e-5)


def test_kv_len_none_means_all_keys():
    inp = _prefill_inputs("gqa", "full")
    full = dict(inp, kv_len=np.full((2,), 12, np.int32))
    np.testing.assert_array_equal(run_port(inp, 0), run_port(full, 0))


def test_dispatch_counts_the_plain_version():
    inp = _decode_inputs("gqa")
    before = tref.LAUNCHES["residual_attention_ref"]
    run_port(inp, 0)
    run_port(_prefill_inputs("gqa", "chunk"), 5)
    assert tref.LAUNCHES["residual_attention_ref"] == before + 2


def _torch_args(inp):
    return [torch.from_numpy(inp[k]) for k in _ORDER]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_kernel_wrappers_refuse_cpu_tensors(kind):
    """The dense kernels' wrappers (#7, #8) never fall back to the plain
    version: handed CPU tensors they raise, and count no launch."""
    before = dict(tra.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if kind == "prefill":
            inp = _prefill_inputs("gqa", "chunk")
            tra.residual_attention_prefill(
                *_torch_args(inp), torch.from_numpy(inp["qpos"]),
                torch.from_numpy(inp["kv_len"]), scale=D ** -0.5)
        else:
            inp = _decode_inputs("gqa")
            args = _torch_args(inp)
            tra.residual_attention_decode(
                args[0][:, 0], *args[1:], torch.from_numpy(inp["kv_len"]),
                scale=D ** -0.5)
    assert tra.LAUNCHES == before


def _qkv(bsz, sq, sk, hq, hkv, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, sq, hq, d)).astype(np.float32),
            rng.standard_normal((bsz, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((bsz, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(window=5),
    dict(q_offset=6, kv_len=[9, 14]),
    dict(causal=False, kv_len=[3, 14]),
])
def test_mha_matches_jax(kw):
    q, k, v = _qkv(2, 8, 14, 8, 2, D)
    kw = dict(kw)
    kv_len = kw.pop("kv_len", None)
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    kv_len=None if kv_len is None else torch.tensor(kv_len),
                    **kw).numpy()
    want = np.asarray(jattn.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_mha_takes_the_banded_path_past_the_threshold(monkeypatch):
    """With ``FLASH_THRESHOLD`` lowered (on the port's module only), a
    causal windowed ``mha`` over contiguous positions goes through
    ``banded_window_attention`` and still equals JAX's plain ``mha``."""
    q, k, v = _qkv(2, 40, 40, 8, 2, D)
    monkeypatch.setattr(tattn, "FLASH_THRESHOLD", 16)
    calls = []
    banded = tattn.banded_window_attention
    monkeypatch.setattr(tattn, "banded_window_attention",
                        lambda *a, **kw: calls.append(1) or banded(*a, **kw))
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), window=7).numpy()
    assert calls
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=7))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("disagg", [False, True])
def test_banded_window_attention_matches_jax(disagg):
    """Sq = 40 over two 16-row q blocks and a ragged last one, window 7,
    with and without the disaggregated reconstruction."""
    q, k, v = _qkv(2, 40, 40, 8, 2, D)
    rng = np.random.default_rng(4)
    res = dict(
        k_res=rng.standard_normal((2, 40, R)).astype(np.float32) * 0.3,
        v_res=rng.standard_normal((2, 40, R)).astype(np.float32) * 0.3,
        b_k=rng.standard_normal((2, R, 2 * D)).astype(np.float32) * 0.3,
        b_v=rng.standard_normal((2, R, 2 * D)).astype(np.float32) * 0.3,
    ) if disagg else {}
    got = tattn.banded_window_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=7, q_block=16,
        **{n: torch.from_numpy(a) for n, a in res.items()}).numpy()
    want = np.asarray(jattn.banded_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=7,
        q_block=16, **{n: jnp.asarray(a) for n, a in res.items()}))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
