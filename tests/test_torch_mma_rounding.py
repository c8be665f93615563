"""The rounding plan of the tensor-core prefill kernels, checked on the CPU.

The bf16 launches of the dense prefill (#7, ``residual_attention.cu``) and
of the paged base-only chunked prefill (#6, ``paged_residual_attention.cu``,
bf16 and int8 pages) run on the tensor cores, which take bf16 operands.
``emulate`` below repeats, in plain torch and in this test only, what
those kernels compute and where they round, key block by key block (64
keys; 32 at head_dim 256):

* the rebuilt K = K_b + RoPE(K_r . B_k), f32 then rounded once to bf16
  (int8 pages: each element bf16(code * scale), the plain version's own
  rounding point);
* S = Q K^T in f32, the running max in the exp2 domain, P in f32 for the
  row sum and rounded to bf16 as the A operand of P . V_b and P . V_r;
* f32 accumulators, and at the end O_r rounded to bf16 for O_r . B_v;
* O / max(l, 1e-20).

With bf16 inputs it is held to the port's plain version (the card's
yardstick) within 0.5% of the plain version's max |value|, half the 1%
that ``chip_smoke.py`` holds the kernels to.  The emulation returns its
f32 output, before the kernel's last rounding to bf16, which adds at most
half a bf16 ulp (<= 0.2% of max |value| here) on the card.  With f32
inputs and no rounding it is the same algorithm in f32, held to the JAX
package's ``repro.kernels.ref`` within 1e-5.

Geometries: Llama3-8B's heads (Hq 32, Hkv 8, D 128, R 16),
RecurrentGemma-9B's (Hq 16, Hkv 1, D 256, R 16), ``tiny_serving_model()``'s
at its defaults (Hq 8, Hkv 4, D 32, R 8) and h2o-danube-3-4b's (Hq 32, Hkv
8, D 120, R 16: the dense tile runs it in D 128's columns in the
split-half layout, emulated by ``tile_layout``), Sq = Sk = 200, causal
with and without a window that straddles key blocks; the paged cases at
Llama3-8B's heads and at the tiny model's, page 16, bf16 and int8 pages, as
the chunked prefill
(#6: n_valid rows) and as the mixed grid (#3: explicit q_len, with a
prefill row, decode rows of q_len 1 and a q_len 0 row), held to the
prefill and the mixed plain versions; and the disaggregated chunked
prefill (#5: the same tile with #7's rebuild), bf16 and int8 pages, whose
K_r/V_r rows come through their own block table and whose RoPE values
are the wrapper's table (``rope_table``, q's type), held to the port's
plain prefill version and in f32 to ``repro.kernels.ref``; and the
disaggregated mixed grid (#1: #5's tile with each row's q_len given) on
ragged mixed rows (q_len 0, 1, 17 and a long prefill row; kv_len 0, 1 and
17), held to the plain mixed version and in f32 to JAX's.  The table is
held to ``rope_sincos`` exactly and to the angles of JAX's
``_reconstruct_k`` within f32 rounding.  Also the routing by type: which
kernel, by its launch counter, a bf16 or f32 launch runs (the split-K
decodes #4 and #2 in every type and #8 in bf16:
``tests/test_torch_splitk.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_residual_attention as jpra
from repro.kernels import ref as jref
from repro.core import rope as jrope
from repro_torch.core import rope as trope
from repro_torch.kernels import paged_residual_attention as tpra
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_attention as tra
from repro_torch.models.transformer import quantize_kv

LOG2E = 1.4426950408889634
HEADS = {"llama3-8b": (32, 8, 128, 16), "recurrentgemma-9b": (16, 1, 256, 16),
         "tiny-serve": (8, 4, 32, 8), "h2o-danube-3-4b": (32, 8, 120, 16)}
SEQ = 200
WINDOWS = (0, 77)
SHARE = 0.005        # half of chip_smoke's BF16_RTOL


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def key_block(d):
    """Keys per block of the tensor-core kernels (``BK``)."""
    return 32 if d == 256 else 64


def emulate(q, k, v, qpos, kv_len, *, scale, window, res=None, lowp):
    """The kernels' online softmax over key blocks.  q: (B, Sq, Hq, D);
    k/v: (B, Sk, Hkv, D) f32 (K already rebuilt and rounded); qpos: (B, Sq);
    kv_len: (B,); ``res`` = (v_res (B, Sk, R), b_v (B, R, Hkv*D)) for the
    disaggregated kernel.  ``lowp`` rounds P and O_r to bf16 where the
    tensor cores take them.  Returns the f32 output (B, Sq, Hq, D)."""
    rnd = (lambda t: t.to(torch.bfloat16).float()) if lowp else \
        (lambda t: t)
    bsz, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(bsz, sq, hkv, g, d)
    m = torch.full((bsz, sq, hkv, g), -1e30)
    l = torch.zeros(bsz, sq, hkv, g)
    o = torch.zeros(bsz, sq, hkv, g, d)
    orr = None if res is None else torch.zeros(bsz, sq, hkv, g,
                                               res[0].shape[-1])
    c = scale * LOG2E
    bk = key_block(d)
    for j0 in range(0, sk, bk):
        sl = slice(j0, min(j0 + bk, sk))
        kp = torch.arange(sk)[sl]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k[:, sl])
        seen = (kp[None, None] < kv_len[:, None, None]) & \
            (kp[None, None] <= qpos[..., None])
        if window:
            seen &= kp[None, None] > qpos[..., None] - window
        s = torch.where(seen[:, :, None, None], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        o = o * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", rnd(p),
                                                v[:, sl])
        if res is not None:
            orr = orr * alpha[..., None] + torch.einsum(
                "bqhgk,bkr->bqhgr", rnd(p), res[0][:, sl].float())
    if res is not None:
        b_v = res[1].float().reshape(bsz, -1, hkv, d)
        o = o + torch.einsum("bqhgr,brhd->bqhgd", rnd(orr), b_v)
    o = o / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(bsz, sq, hq, d)


def rebuild_k(k_base, k_res, b_k, sin, cos, lowp):
    """K = K_b + RoPE(K_r . B_k) in f32, rounded once to bf16 (``lowp``)."""
    bsz, sk, hkv, d = k_base.shape
    kl = torch.einsum("bsr,brn->bsn", k_res.float(),
                      b_k.float()).reshape(bsz, sk, hkv, d)
    x1, x2 = kl[..., :d // 2], kl[..., d // 2:]
    sn, cs = sin.float()[:, :, None], cos.float()[:, :, None]
    k = k_base.float() + torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn],
                                   -1)
    return k.to(torch.bfloat16).float() if lowp else k


def dense_inputs(model, seed, rank=None):
    hq, hkv, d, r = HEADS[model]
    r = rank or r
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = 2
    inv = 1.0 / (10_000.0 ** (np.arange(d // 2, dtype=np.float32) /
                              (d // 2)))
    ang = np.arange(SEQ, dtype=np.float32)[:, None] * inv
    tab = lambda t: np.broadcast_to(t, (bsz, SEQ, d // 2)).copy()  # noqa
    return dict(
        q=f(bsz, SEQ, hq, d), k_base=f(bsz, SEQ, hkv, d),
        v_base=f(bsz, SEQ, hkv, d), k_res=f(bsz, SEQ, r) * 0.3,
        v_res=f(bsz, SEQ, r) * 0.3, b_k=f(bsz, r, hkv * d) * 0.3,
        b_v=f(bsz, r, hkv * d) * 0.3, sin=tab(np.sin(ang)),
        cos=tab(np.cos(ang)),
        qpos=np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                             (bsz, SEQ)).copy(),
        # the second row's cache holds fewer valid keys than Sk
        kv_len=np.asarray([SEQ, SEQ - 37], np.int32))


_CACHE = ("k_base", "v_base", "k_res", "v_res", "b_k", "b_v", "sin", "cos")


def tile_layout(t):
    """The dense inputs as the bf16 kernels hold them on chip: head rows
    in the tile's columns (``tra.tile_columns``; at head_dim 120 the two
    halves at tile columns 0.. and 64.. of 128, the rest zero), sin/cos in
    the first d/2 of the tile's half.  The identity where the tile is the
    head's width."""
    d = t["q"].shape[-1]
    w = tra.tile_dim(d)
    if w == d:
        return t
    cols = tra.tile_columns(d)

    def spread(x):
        out = torch.zeros(x.shape[:-1] + (w,), dtype=x.dtype)
        out[..., cols] = x
        return out

    def heads(b):        # (B, R, Hkv*D)
        return spread(b.reshape(b.shape[:2] + (-1, d))).reshape(
            b.shape[:2] + (-1,))

    half = lambda x: torch.cat([x, torch.zeros(  # noqa: E731
        x.shape[:-1] + ((w - d) // 2,), dtype=x.dtype)], -1)
    return dict(t, q=spread(t["q"]), k_base=spread(t["k_base"]),
                v_base=spread(t["v_base"]), b_k=heads(t["b_k"]),
                b_v=heads(t["b_v"]), sin=half(t["sin"]), cos=half(t["cos"]))


def emulate_dense(t, window, lowp):
    """#7's tile, in its layout (``tile_layout``); the real columns of
    its output."""
    d = t["q"].shape[-1]
    t = tile_layout(t)
    k = rebuild_k(t["k_base"], t["k_res"], t["b_k"], t["sin"], t["cos"],
                  lowp)
    out = emulate(t["q"], k, t["v_base"].float(), t["qpos"].long(),
                  t["kv_len"].long(), scale=d ** -0.5, window=window,
                  res=(t["v_res"], t["b_v"]), lowp=lowp)
    return out[..., tra.tile_columns(d)]


def rows_seeing_a_key(t, window):
    """(B, Sq) rows that see at least one key (the rest average V in the
    plain versions and are 0 in the kernels)."""
    qp, kvl = t["qpos"].long(), t["kv_len"].long()[:, None]
    lo = torch.clamp(qp - window + 1, min=0) if window else \
        torch.zeros_like(qp)
    return lo <= torch.minimum(qp, kvl - 1)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("model", list(HEADS))
def test_dense_rounding_plan_holds_half_the_bf16_gate(model, window):
    inp = dense_inputs(model, seed=11)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    bf = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
          for k, v in t.items()}
    d = t["q"].shape[-1]
    want = tref.residual_attention_ref(
        bf["q"], *[bf[k] for k in _CACHE], qpos=bf["qpos"],
        kv_len=bf["kv_len"], window=window, scale=d ** -0.5).float()
    got = emulate_dense(bf, window, lowp=True)
    rows = rows_seeing_a_key(t, window)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("model", list(HEADS))
def test_dense_algorithm_matches_jax_in_f32(model, window):
    inp = dense_inputs(model, seed=12)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    d = t["q"].shape[-1]
    got = emulate_dense(t, window, lowp=False).numpy()
    want = np.asarray(jref.residual_attention_ref(
        *[jnp.asarray(inp[k]) for k in ("q",) + _CACHE],
        qpos=jnp.asarray(inp["qpos"]), kv_len=jnp.asarray(inp["kv_len"]),
        window=window, scale=d ** -0.5))
    rows = rows_seeing_a_key(t, window).numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- paged
PAGE = 16
START, N_VALID = [0, 40], [SEQ, 150]     # a full chunk, a padded one


# the mixed grid (#3 in bf16 runs the same tile with each row's q_len
# given): a 160-position prefill row from mid-page, two decode rows
# (q_len 1) and a q_len 0 row
MIXED = dict(start=[40, 199, 63, 0], n_valid=[160, 1, 1, 0], sq=160)


def pages_and_heads(*pages):
    """``pages`` at Llama3-8B's heads (ids as before), at the tiny model's
    (head_dim 32, G 2, R 8) and at h2o-danube-3-4b's (head_dim 120 in D
    128's tile)."""
    return [pytest.param(p, "llama3-8b", id=p) for p in pages] + \
        [pytest.param(p, "tiny-serve", id=f"{p}-tiny-serve")
         for p in pages] + \
        [pytest.param(p, "h2o-danube-3-4b", id=f"{p}-d120") for p in pages]


def to_tile(x, d):
    """Head rows of ``d`` columns (the last dim) in the paged tiles'
    columns (``tra.tile_dim``): the split-half layout at head_dim 120,
    the gap columns zero; the identity where the tile is ``d`` wide."""
    w = tra.tile_dim(d)
    if w == d:
        return x
    out = torch.zeros(x.shape[:-1] + (w,), dtype=x.dtype)
    out[..., tra.tile_columns(d)] = x
    return out


def heads_to_tile(b, d):
    """(B, R, Hkv * d) rows of B_k/B_v with each head in the tile."""
    return to_tile(b.reshape(b.shape[:2] + (-1, d)), d).reshape(
        b.shape[:2] + (-1,))


def half_to_tile(x, d):
    """sin/cos rows of d/2 in the first d/2 of the tile's half."""
    w = tra.tile_dim(d)
    return torch.cat([x, torch.zeros(x.shape[:-1] + ((w - d) // 2,),
                                     dtype=x.dtype)], -1)


def int8_groups(d):
    """How the tensor-core kernels dequantize a head row of ``d`` int8
    codes into the tile (``flash::dequantize_cols``): (first code, tile
    column, codes) of each group.  Groups of 8 where the tile is ``d``
    wide; at head_dim 120 groups of 4, so none straddles the second half,
    which starts at code 60 (a 4-byte boundary only) and lands at tile
    column 64."""
    n = 8 if tra.tile_dim(d) == d else 4
    cols = tra.tile_columns(d)
    return [(u, int(cols[u]), n) for u in range(0, d, n)]


def dequant_tile(codes, sc, dtype):
    """int8 codes (..., d) with scales (...,) dequantized into the tile as
    the kernels do it (``int8_groups``: groups of 8, or of 4 split at the
    second half at head_dim 120), each element bf16(code * scale)."""
    d = codes.shape[-1]
    out = torch.zeros(codes.shape[:-1] + (tra.tile_dim(d),), dtype=dtype)
    for u, col, n in int8_groups(d):
        out[..., col:col + n] = (codes[..., u:u + n].float() *
                                 sc[..., None]).to(dtype)
    return out


def paged_inputs(seed, start=START, n_valid=N_VALID, sq=SEQ,
                 heads="llama3-8b"):
    hq, hkv, d, _ = HEADS[heads]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = len(start)
    width = (max(s + n for s, n in zip(start, n_valid)) + PAGE - 1) // PAGE
    pool = bsz * width + 3
    bt = rng.permutation(pool)[:bsz * width].reshape(bsz, width)
    return dict(q=f(bsz, sq, hq, d), kb=f(pool, PAGE, hkv, d),
                vb=f(pool, PAGE, hkv, d), bt_b=bt.astype(np.int32),
                start=np.asarray(start, np.int32),
                q_len=np.asarray(n_valid, np.int32),
                kv_len=np.asarray([s + n for s, n in zip(start, n_valid)],
                                  np.int32))


def emulate_paged(t, window, lowp, ks=None, vs=None):
    """The paged kernel in its tile's columns (``to_tile``): pages gathered
    by position (int8: dequantized to q's type into the tile first, group
    by group, ``dequant_tile``), then ``emulate`` without the residual
    stream; the head's real columns of the output, rows at or past n_valid
    (the mixed grid's q_len) zeros."""
    bsz, sq, _, d = t["q"].shape
    hkv = t["kb"].shape[2]
    bt = t["bt_b"].long()
    sk = bt.shape[1] * PAGE

    def gather(pool, sc):
        x = pool[bt].reshape(bsz, sk, hkv, d)
        if sc is not None:
            return dequant_tile(x, sc[bt].reshape(bsz, sk, hkv),
                                t["q"].dtype).float()
        return to_tile(x, d).float()

    qpos = t["start"].long()[:, None] + torch.arange(sq)[None]
    out = emulate(to_tile(t["q"], d), gather(t["kb"], ks),
                  gather(t["vb"], vs), qpos, t["kv_len"].long(),
                  scale=d ** -0.5, window=window, lowp=lowp)
    out = out[..., tra.tile_columns(d)]
    valid = torch.arange(sq)[None] < t["q_len"][:, None]
    return out * valid[:, :, None, None]


def valid_rows(n_valid=N_VALID, sq=SEQ):
    return torch.arange(sq)[None] < torch.tensor(n_valid)[:, None]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("bf16", "int8"))
def test_paged_rounding_plan_holds_half_the_bf16_gate(pages, heads, window):
    inp = paged_inputs(seed=13, heads=heads)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in ("q", "kb", "vb"):
        t[k] = t[k].to(torch.bfloat16)
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    want = tref.paged_residual_attention_prefill_ref(
        t["q"], t["kb"], t["vb"], None, None, None, None, t["bt_b"], None,
        t["start"], t["kv_len"], window=window, kb_scale=ks,
        vb_scale=vs).float()
    got = emulate_paged(t, window, lowp=True, ks=ks, vs=vs)
    rows = valid_rows()
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("f32", "int8"))
def test_paged_algorithm_matches_jax_in_f32(pages, heads, window):
    inp = paged_inputs(seed=14, heads=heads)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    got = emulate_paged(t, window, lowp=False, ks=ks, vs=vs).numpy()
    j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa
    want = np.asarray(jref.paged_residual_attention_prefill_ref(
        j(t["q"]), j(t["kb"]), j(t["vb"]), None, None, None, None,
        j(t["bt_b"]), None, j(t["start"]), j(t["kv_len"]), window=window,
        kb_scale=j(ks), vb_scale=j(vs)))
    rows = valid_rows().numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)



def mixed_case(seed, pages, lowp, heads="llama3-8b"):
    t = {k: torch.from_numpy(v)
         for k, v in paged_inputs(seed, **MIXED, heads=heads).items()}
    if lowp:
        for k in ("q", "kb", "vb"):
            t[k] = t[k].to(torch.bfloat16)
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    return t, ks, vs


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("bf16", "int8"))
def test_paged_mixed_rounding_plan_holds_half_the_bf16_gate(pages, heads,
                                                            window):
    """The tile on the mixed grid's rows (explicit q_len: a prefill row,
    decode rows, a q_len 0 row) against the plain mixed version, which
    zeroes the rows past q_len as the kernel does."""
    t, ks, vs = mixed_case(15, pages, lowp=True, heads=heads)
    want = tref.paged_residual_attention_mixed_ref(
        t["q"], t["kb"], t["vb"], None, None, None, None, t["bt_b"], None,
        t["start"], t["q_len"], t["kv_len"], window=window, kb_scale=ks,
        vb_scale=vs).float()
    got = emulate_paged(t, window, lowp=True, ks=ks, vs=vs)
    rows = valid_rows(MIXED["n_valid"], MIXED["sq"])
    assert torch.all(got[~rows] == 0.0) and torch.all(want[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("f32", "int8"))
def test_paged_mixed_algorithm_matches_jax_in_f32(pages, heads, window):
    t, ks, vs = mixed_case(16, pages, lowp=False, heads=heads)
    got = emulate_paged(t, window, lowp=False, ks=ks, vs=vs).numpy()
    j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa
    want = np.asarray(jref.paged_residual_attention_mixed_ref(
        j(t["q"]), j(t["kb"]), j(t["vb"]), None, None, None, None,
        j(t["bt_b"]), None, j(t["start"]), j(t["q_len"]), j(t["kv_len"]),
        window=window, kb_scale=j(ks), vb_scale=j(vs)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------- paged, disaggregated (#5)
def res_paged_inputs(seed, heads="llama3-8b", rank=None, **rows):
    """``paged_inputs`` (on ``rows``) plus residual pools (Pr, page, R)
    behind their own block table and per-row B_k/B_v (B, R, Hkv * D); R
    the heads' rank unless ``rank`` is given."""
    t = paged_inputs(seed, heads=heads, **rows)
    rank = rank or HEADS[heads][3]
    rng = np.random.default_rng(seed + 100)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz, width = t["bt_b"].shape
    hkv, d = t["kb"].shape[2], t["kb"].shape[3]
    pool_r = bsz * width + 5
    t.update(kr=f(pool_r, PAGE, rank) * 0.3, vr=f(pool_r, PAGE, rank) * 0.3,
             b_k=f(bsz, rank, hkv * d) * 0.3, b_v=f(bsz, rank, hkv * d) * 0.3,
             bt_r=rng.permutation(pool_r)[:bsz * width].reshape(
                 bsz, width).astype(np.int32))
    return t


def emulate_paged_res(t, window, lowp, ks=None, vs=None):
    """#5's tile: base pages gathered by position (int8: dequantized to q's
    type), residual rows through bt_r, K rebuilt with sin/cos from the
    wrapper's table in q's type and rounded once (``rebuild_k``), then
    ``emulate`` with the residual stream; rows at or past n_valid are
    zeros."""
    bsz, sq, _, d = t["q"].shape
    hkv = t["kb"].shape[2]
    bt, btr = t["bt_b"].long(), t["bt_r"].long()
    sk = bt.shape[1] * PAGE

    def gather(pool, sc):
        x = pool[bt].reshape(bsz, sk, hkv, d)
        if sc is not None:
            return dequant_tile(x, sc[bt].reshape(bsz, sk, hkv),
                                t["q"].dtype)
        return to_tile(x, d)

    table = tpra.rope_table(torch.device("cpu"), d, 10_000.0, t["q"].dtype,
                            sk)
    sin, cos = (half_to_tile(table[i, :sk], d).expand(
        bsz, sk, tra.tile_dim(d) // 2) for i in (0, 1))
    k = rebuild_k(gather(t["kb"], ks), t["kr"][btr].reshape(bsz, sk, -1),
                  heads_to_tile(t["b_k"], d), sin, cos, lowp)
    qpos = t["start"].long()[:, None] + torch.arange(sq)[None]
    out = emulate(to_tile(t["q"], d), k, gather(t["vb"], vs).float(), qpos,
                  t["kv_len"].long(), scale=d ** -0.5, window=window,
                  res=(t["vr"][btr].reshape(bsz, sk, -1),
                       heads_to_tile(t["b_v"], d)),
                  lowp=lowp)
    out = out[..., tra.tile_columns(d)]
    valid = torch.arange(sq)[None] < t["q_len"][:, None]
    return out * valid[:, :, None, None]


_RES = ("kr", "vr", "b_k", "b_v")


def res_case(seed, pages, lowp, rows=None, heads="llama3-8b", rank=None):
    t = {k: torch.from_numpy(v)
         for k, v in res_paged_inputs(seed, heads, rank,
                                      **(rows or {})).items()}
    if lowp:
        for k in ("q", "kb", "vb") + _RES:
            t[k] = t[k].to(torch.bfloat16)
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    return t, ks, vs


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("bf16", "int8"))
def test_paged_res_rounding_plan_holds_half_the_bf16_gate(pages, heads,
                                                          window):
    t, ks, vs = res_case(17, pages, lowp=True, heads=heads)
    want = tref.paged_residual_attention_prefill_ref(
        t["q"], t["kb"], t["vb"], *[t[k] for k in _RES], t["bt_b"],
        t["bt_r"], t["start"], t["kv_len"], window=window, kb_scale=ks,
        vb_scale=vs).float()
    got = emulate_paged_res(t, window, lowp=True, ks=ks, vs=vs)
    rows = valid_rows()
    assert torch.all(got[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("f32", "int8"))
def test_paged_res_algorithm_matches_jax_in_f32(pages, heads, window):
    t, ks, vs = res_case(18, pages, lowp=False, heads=heads)
    got = emulate_paged_res(t, window, lowp=False, ks=ks, vs=vs).numpy()
    j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa
    want = np.asarray(jref.paged_residual_attention_prefill_ref(
        *[j(t[k]) for k in ("q", "kb", "vb") + _RES + ("bt_b", "bt_r",
                                                      "start", "kv_len")],
        window=window, kb_scale=j(ks), vb_scale=j(vs)))
    rows = valid_rows().numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)


# #1 in bf16 runs #5's tile with each row's q_len given: a q_len 0 row at
# kv_len 0, a decode row at kv_len 1, 17 positions from 0, a decode row at
# kv_len 17, a 160-position prefill row from mid-page and a decode row at
# kv_len 200 (chip_smoke's ``RES_MIXED_ROWS`` at this test's size)
RES_MIXED = dict(start=[0, 0, 0, 16, 40, 199], n_valid=[0, 1, 17, 1, 160, 1],
                 sq=160)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("bf16", "int8"))
def test_paged_res_mixed_rounding_plan_holds_half_the_bf16_gate(pages, heads,
                                                                window):
    """#5's tile on #1's ragged rows against the plain mixed version,
    which zeroes the rows past q_len as the kernel does (the q_len 0 row
    at kv_len 0 too)."""
    t, ks, vs = res_case(19, pages, lowp=True, rows=RES_MIXED, heads=heads)
    want = tref.paged_residual_attention_mixed_ref(
        t["q"], t["kb"], t["vb"], *[t[k] for k in _RES], t["bt_b"],
        t["bt_r"], t["start"], t["q_len"], t["kv_len"], window=window,
        kb_scale=ks, vb_scale=vs).float()
    got = emulate_paged_res(t, window, lowp=True, ks=ks, vs=vs)
    rows = valid_rows(RES_MIXED["n_valid"], RES_MIXED["sq"])
    assert torch.all(got[~rows] == 0.0) and torch.all(want[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pages,heads", pages_and_heads("f32", "int8"))
def test_paged_res_mixed_algorithm_matches_jax_in_f32(pages, heads, window):
    t, ks, vs = res_case(20, pages, lowp=False, rows=RES_MIXED, heads=heads)
    got = emulate_paged_res(t, window, lowp=False, ks=ks, vs=vs).numpy()
    j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa
    want = np.asarray(jref.paged_residual_attention_mixed_ref(
        *[j(t[k]) for k in ("q", "kb", "vb") + _RES + ("bt_b", "bt_r",
                                                      "start", "q_len",
                                                      "kv_len")],
        window=window, kb_scale=j(ks), vb_scale=j(vs)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------ ranks above 64: the chunked plan
# The chunked instances (``csrc/rank_chunk.cuh``) rebuild a key block's K
# and V on chip one rank chunk of 64 at a time: each chunk's products in
# f32, added to the f32 sums in order; K = bf16(K_b + RoPE(sums)) and V =
# bf16(V_b + sums), rounded once (the plain version's reconstruct rounds
# V there too); then the online softmax with P in bf16 and no O_r.
RANK = 128


def chunk_sums(res, b):
    """res (B, Sk, R) . b (B, R, N), the rank in chunks of
    ``tra.RANK_CHUNK`` summed in f32 in order."""
    out = 0.0
    for c in range(0, res.shape[-1], tra.RANK_CHUNK):
        out = out + torch.einsum("bsr,brn->bsn",
                                 res[..., c:c + tra.RANK_CHUNK].float(),
                                 b[:, c:c + tra.RANK_CHUNK].float())
    return out


def rebuild_chunked(base, res, b, lowp, sin=None, cos=None):
    """K (with sin/cos: RoPE on the sums) or V of the chunked instances,
    rounded once to bf16 (``lowp``)."""
    bsz, sk, hkv, d = base.shape
    x = chunk_sums(res, b).reshape(bsz, sk, hkv, d)
    if sin is not None:
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        sn, cs = sin.float()[:, :, None], cos.float()[:, :, None]
        x = torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn], -1)
    out = base.float() + x
    return out.to(torch.bfloat16).float() if lowp else out


def emulate_dense_chunked(t, window, lowp):
    """#7's and #8's chunked instances, in the tile's layout."""
    d = t["q"].shape[-1]
    t = tile_layout(t)
    k = rebuild_chunked(t["k_base"], t["k_res"], t["b_k"], lowp, t["sin"],
                        t["cos"])
    v = rebuild_chunked(t["v_base"], t["v_res"], t["b_v"], lowp)
    out = emulate(t["q"], k, v, t["qpos"].long(), t["kv_len"].long(),
                  scale=d ** -0.5, window=window, lowp=lowp)
    return out[..., tra.tile_columns(d)]


def emulate_paged_chunked(t, window, lowp, ks=None, vs=None):
    """#5's and #1's chunked instance: ``emulate_paged_res`` with V rebuilt
    (``rebuild_chunked``) and no residual stream; rows at or past q_len
    are zeros."""
    bsz, sq, _, d = t["q"].shape
    hkv = t["kb"].shape[2]
    bt, btr = t["bt_b"].long(), t["bt_r"].long()
    sk = bt.shape[1] * PAGE

    def gather(pool, sc):
        x = pool[bt].reshape(bsz, sk, hkv, d)
        if sc is not None:
            return dequant_tile(x, sc[bt].reshape(bsz, sk, hkv),
                                t["q"].dtype)
        return to_tile(x, d)

    table = tpra.rope_table(torch.device("cpu"), d, 10_000.0, t["q"].dtype,
                            sk)
    sin, cos = (half_to_tile(table[i, :sk], d).expand(
        bsz, sk, tra.tile_dim(d) // 2) for i in (0, 1))
    res = {n: t[n][btr].reshape(bsz, sk, -1) for n in ("kr", "vr")}
    k = rebuild_chunked(gather(t["kb"], ks), res["kr"],
                        heads_to_tile(t["b_k"], d), lowp, sin, cos)
    v = rebuild_chunked(gather(t["vb"], vs), res["vr"],
                        heads_to_tile(t["b_v"], d), lowp)
    qpos = t["start"].long()[:, None] + torch.arange(sq)[None]
    out = emulate(to_tile(t["q"], d), k, v, qpos, t["kv_len"].long(),
                  scale=d ** -0.5, window=window, lowp=lowp)
    out = out[..., tra.tile_columns(d)]
    valid = torch.arange(sq)[None] < t["q_len"][:, None]
    return out * valid[:, :, None, None]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("model", ["llama3-8b", "recurrentgemma-9b",
                                   "h2o-danube-3-4b"])
def test_dense_chunked_rounding_plan_at_rank_128(model, window):
    inp = dense_inputs(model, seed=41, rank=RANK)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    bf = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
          for k, v in t.items()}
    d = t["q"].shape[-1]
    want = tref.residual_attention_ref(
        bf["q"], *[bf[k] for k in _CACHE], qpos=bf["qpos"],
        kv_len=bf["kv_len"], window=window, scale=d ** -0.5).float()
    got = emulate_dense_chunked(bf, window, lowp=True)
    rows = rows_seeing_a_key(t, window)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
def test_dense_chunked_algorithm_matches_jax_in_f32(window):
    inp = dense_inputs("llama3-8b", seed=42, rank=RANK)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = emulate_dense_chunked(t, window, lowp=False).numpy()
    want = np.asarray(jref.residual_attention_ref(
        *[jnp.asarray(inp[k]) for k in ("q",) + _CACHE],
        qpos=jnp.asarray(inp["qpos"]), kv_len=jnp.asarray(inp["kv_len"]),
        window=window))
    rows = rows_seeing_a_key(t, window).numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("grid", ["chunked prefill", "mixed"])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_paged_chunked_rounding_plan_at_rank_128(pages, grid, window):
    """#5's rows (n_valid) against the plain prefill version, #1's ragged
    rows (q_len given) against the plain mixed version."""
    mixed = grid == "mixed"
    t, ks, vs = res_case(43, pages, lowp=True, rank=RANK,
                         rows=RES_MIXED if mixed else None)
    args = (t["q"], t["kb"], t["vb"], *[t[k] for k in _RES], t["bt_b"],
            t["bt_r"], t["start"])
    kw = dict(window=window, kb_scale=ks, vb_scale=vs)
    want = (tref.paged_residual_attention_mixed_ref(
        *args, t["q_len"], t["kv_len"], **kw) if mixed else
        tref.paged_residual_attention_prefill_ref(
            *args, t["kv_len"], **kw)).float()
    got = emulate_paged_chunked(t, window, lowp=True, ks=ks, vs=vs)
    rows = valid_rows(RES_MIXED["n_valid"], RES_MIXED["sq"]) if mixed \
        else valid_rows()
    assert torch.all(got[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_int8_groups_cover_each_code_once(d):
    """The kernels' int8 groups (``int8_groups``) take every code of a
    head row once, in groups that never straddle the second half (at
    head_dim 120: groups of 4, the half starting at code 60), each landing
    at its tile column; a whole row dequantized so equals the plain
    version's dequantized row in the tile, bit for bit."""
    groups = int8_groups(d)
    codes = [u + i for u, _, n in groups for i in range(n)]
    assert codes == list(range(d))
    cols = tra.tile_columns(d)
    for u, col, n in groups:
        assert (u < d // 2) == (u + n - 1 < d // 2)      # one half each
        assert list(cols[u:u + n]) == list(range(col, col + n))
        if tra.tile_dim(d) != d:
            assert n == 4 and u % 4 == 0
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((5, 3, d)).astype(np.float32))
    q, sc = quantize_kv(x)
    plain = (q.float() * sc[..., None]).to(torch.bfloat16)
    assert torch.equal(dequant_tile(q, sc, torch.bfloat16),
                       to_tile(plain, d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 32, 120])
def test_rope_table_is_the_plain_versions_sincos(d, dtype):
    """Row p of the table is ``rope_sincos(p)`` rounded to q's type, bit
    for bit, at every position a launch of W * page keys reads; it grows
    when a launch needs more rows; without RoPE it is sin 0, cos 1."""
    dev = torch.device("cpu")
    rows = 5000                                   # past the first 4096
    table = tpra.rope_table(dev, d, 10_000.0, dtype, rows)
    assert table.shape[0] == 2 and table.shape[1] >= rows
    assert table.shape[2] == d // 2 and table.dtype == dtype
    pos = torch.arange(rows)
    sin, cos = trope.rope_sincos(pos, d, 10_000.0)
    assert torch.equal(table[0, :rows], sin.to(dtype))
    assert torch.equal(table[1, :rows], cos.to(dtype))
    assert tpra.rope_table(dev, d, 10_000.0, dtype, 100) is table
    bigger = tpra.rope_table(dev, d, 10_000.0, dtype, 3 * table.shape[1])
    assert torch.equal(bigger[:, :rows], table[:, :rows])
    plain = tpra.rope_table(dev, d, 10_000.0, dtype, rows, use_rope=False)
    assert torch.all(plain[0] == 0) and torch.all(plain[1] == 1)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_table_matches_jax_angles(theta):
    """The f32 table against JAX's ``rope_sincos`` and against the angles
    JAX's Pallas kernels use (``_reconstruct_k``: RoPE from the logical
    position j * page + t), read off a rebuild of x = [1, 0] rows (out =
    [cos, sin]) of pages 0, 7 and 255, within f32 rounding."""
    d, page = 128, 16
    table = tpra.rope_table(torch.device("cpu"), d, theta, torch.float32,
                            4096).numpy()
    pos = np.arange(4096, dtype=np.int32)
    jsin, jcos = jrope.rope_sincos(jnp.asarray(pos), d, theta)
    np.testing.assert_allclose(table[0, :4096], np.asarray(jsin), atol=2e-6)
    np.testing.assert_allclose(table[1, :4096], np.asarray(jcos), atol=2e-6)
    kb = jnp.zeros((1, page, 1, d), jnp.float32)
    kr = jnp.ones((1, page, 1), jnp.float32)
    bk = jnp.asarray(np.concatenate([np.ones(d // 2), np.zeros(d // 2)]
                                    ).astype(np.float32)[None, None, None])
    for j in (0, 7, 255):
        k = np.asarray(jpra._reconstruct_k(kb, kr, bk, j, page=page, d=d,
                                           rope_theta=theta, use_rope=True))
        rows = table[:, j * page:(j + 1) * page]
        np.testing.assert_allclose(k[:, :d // 2], rows[1], atol=2e-6)
        np.testing.assert_allclose(k[:, d // 2:], rows[0], atol=2e-6)


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype,int8,want", [
    (torch.bfloat16, False, "paged_attention_prefill_base_mma"),
    (torch.bfloat16, True, "paged_attention_prefill_base_int8_mma"),
    (torch.float32, False, "paged_attention_prefill_base"),
    (torch.float32, True, "paged_attention_prefill_base_int8"),
])
def test_paged_prefill_base_routes_by_dtype(dtype, int8, want):
    """bf16 launches of #6 (bf16 or int8 pages) go to the tensor-core
    kernel and are counted apart; f32 ones stay on the template."""
    got = tpra.kernel_name("paged_attention_prefill_base", dtype, int8)
    assert got == want and got in tpra.LAUNCHES


@pytest.mark.parametrize("dtype,int8,want", [
    (torch.bfloat16, False, "paged_attention_mixed_base_mma"),
    (torch.bfloat16, True, "paged_attention_mixed_base_int8_mma"),
    (torch.float32, False, "paged_attention_mixed_base"),
    (torch.float32, True, "paged_attention_mixed_base_int8"),
])
def test_paged_mixed_base_routes_by_dtype(dtype, int8, want):
    """bf16 launches of #3 (bf16 or int8 pages) go to #6's tensor-core
    kernel and are counted apart; f32 ones stay on the template."""
    got = tpra.kernel_name("paged_attention_mixed_base", dtype, int8)
    assert got == want and got in tpra.LAUNCHES


@pytest.mark.parametrize("dtype,int8,want", [
    (torch.bfloat16, False, "paged_attention_decode_base_splitk"),
    (torch.bfloat16, True, "paged_attention_decode_base_int8_splitk"),
    (torch.float32, False, "paged_attention_decode_base_splitk"),
    (torch.float32, True, "paged_attention_decode_base_int8_splitk"),
])
def test_paged_decode_base_is_always_splitk(dtype, int8, want):
    """Every launch of #4 runs the split-K decode, whatever the type."""
    got = tpra.kernel_name("paged_attention_decode_base", dtype, int8)
    assert got == want and got in tpra.LAUNCHES


@pytest.mark.parametrize("dtype,int8,want", [
    (torch.bfloat16, False, "paged_residual_attention_prefill_mma"),
    (torch.bfloat16, True, "paged_residual_attention_prefill_int8_mma"),
    (torch.float32, False, "paged_residual_attention_prefill"),
    (torch.float32, True, "paged_residual_attention_prefill_int8"),
])
def test_paged_res_prefill_routes_by_dtype(dtype, int8, want):
    """bf16 launches of #5 (bf16 or int8 pages) go to its tensor-core tile
    and are counted apart; f32 ones stay on the template."""
    got = tpra.kernel_name("paged_residual_attention_prefill", dtype, int8)
    assert got == want and got in tpra.LAUNCHES


@pytest.mark.parametrize("dtype,int8,want", [
    (torch.bfloat16, False, "paged_residual_attention_mixed_mma"),
    (torch.bfloat16, True, "paged_residual_attention_mixed_int8_mma"),
    (torch.float32, False, "paged_residual_attention_mixed"),
    (torch.float32, True, "paged_residual_attention_mixed_int8"),
])
def test_paged_res_mixed_routes_by_dtype(dtype, int8, want):
    """bf16 launches of #1 (bf16 or int8 pages) go to #5's tensor-core tile
    and are counted apart; f32 ones stay on the template."""
    got = tpra.kernel_name("paged_residual_attention_mixed", dtype, int8)
    assert got == want and got in tpra.LAUNCHES


@pytest.mark.parametrize("dtype,int8,want", [
    (torch.bfloat16, False, "paged_residual_attention_decode_splitk"),
    (torch.bfloat16, True, "paged_residual_attention_decode_int8_splitk"),
    (torch.float32, False, "paged_residual_attention_decode_splitk"),
    (torch.float32, True, "paged_residual_attention_decode_int8_splitk"),
])
def test_paged_res_decode_is_always_splitk(dtype, int8, want):
    """Every launch of #2 runs the split-K decode, whatever the type; no
    counter of a template instance of #2 is left."""
    got = tpra.kernel_name("paged_residual_attention_decode", dtype, int8)
    assert got == want and got in tpra.LAUNCHES
    assert "paged_residual_attention_decode" not in tpra.LAUNCHES
    assert "paged_residual_attention_decode_int8" not in tpra.LAUNCHES


@pytest.mark.parametrize("entry", tpra.ENTRIES)
def test_every_routed_counter_is_in_launches(entry):
    """Each kernel an entry can run has a launch counter, and no counter
    names a template instance that no launch can reach."""
    routed = {tpra.kernel_name(e, dt, i8, r) for e in tpra.ENTRIES
              for dt in (torch.bfloat16, torch.float32)
              for i8 in (False, True) for r in (16, 128)}
    assert routed == set(tpra.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float32):
        for int8 in (False, True):
            assert tpra.kernel_name(entry, dtype, int8) in tpra.LAUNCHES


@pytest.mark.parametrize("entry", tpra.ENTRIES)
def test_other_paged_entries_keep_the_template(entry):
    """No paged entry reaches the template in bf16: each runs a tensor-core
    tile or a split-K decode; in f32 every entry but the split-K decodes
    keeps the template, under the entry's own name."""
    assert entry in tpra.MMA_ENTRIES + tpra.SPLIT_ENTRIES
    for int8 in (False, True):
        template = f"{entry}_int8" if int8 else entry
        assert tpra.kernel_name(entry, torch.bfloat16, int8) != template
        want = f"{template}_splitk" if entry in tpra.SPLIT_ENTRIES \
            else template
        assert tpra.kernel_name(entry, torch.float32, int8) == want


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "residual_attention_prefill_mma"),
    (torch.float32, "residual_attention_prefill"),
])
def test_dense_prefill_routes_by_dtype(dtype, want):
    assert tra.prefill_kernel(dtype) == want and want in tra.LAUNCHES


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "residual_attention_decode_splitk"),
    (torch.float32, "residual_attention_decode"),
])
def test_dense_decode_routes_by_dtype(dtype, want):
    """bf16 launches of #8 run the split-K decode, counted apart; f32 ones
    the scalar kernel.  Every dense counter is one a launch can reach."""
    assert tra.decode_kernel(dtype) == want and want in tra.LAUNCHES
    routed = {f(dt, r) for f in (tra.prefill_kernel, tra.decode_kernel)
              for dt in (torch.bfloat16, torch.float32) for r in (16, 128)}
    assert routed == set(tra.LAUNCHES)


@pytest.mark.parametrize("d,group,sq,dtype,positions", [
    (128, 4, 1000, torch.bfloat16, 32),    # Llama3-8B: 128 rows
    (256, 16, 1000, torch.bfloat16, 8),    # RecurrentGemma-9B: 128 rows
    (256, 16, 1000, torch.float32, 2),     # the scalar kernel: 32 at D 256
    (128, 4, 1000, torch.float32, 16),     # and 64 at D 128
    (128, 64, 5, torch.bfloat16, 2),
    (64, 4, 3, torch.bfloat16, 3),         # at most Sq
    (120, 4, 1000, torch.bfloat16, 32),    # h2o-danube-3-4b: D 128's tile
    (120, 4, 1000, torch.float32, 16),
])
def test_tile_positions_by_kernel(d, group, sq, dtype, positions):
    assert tra.tile_positions(d, group, sq, dtype) == positions


def test_split_half_layout_keeps_ropes_pairs():
    """At head_dim 120 the tile is 128 wide and column c's RoPE partner c +
    60 sits at tile column c + 64, the tile's own pairing; 60..63 and
    124..127 hold no column.  Every other head_dim is its own tile."""
    cols = tra.tile_columns(120)
    assert tra.tile_dim(120) == 128
    assert cols.tolist() == list(range(60)) + list(range(64, 124))
    assert torch.equal(cols[60:] - cols[:60], torch.full((60,), 64))
    for d in (32, 64, 128, 256):
        assert tra.tile_dim(d) == d
        assert torch.equal(tra.tile_columns(d), torch.arange(d))


@pytest.mark.parametrize("dtype,positions", [(torch.bfloat16, 32),
                                             (torch.float32, 16)])
def test_paged_tile_positions_by_kernel(dtype, positions):
    """#6, #3 and #1 in bf16: 128 rows per CTA (Llama3-8B's G 4: 32
    positions); the template (f32): 64 rows."""
    for entry in ("paged_attention_prefill_base",
                  "paged_attention_mixed_base",
                  "paged_residual_attention_mixed"):
        assert tpra.tile_positions(entry, dtype, 4, 2048) == positions


@pytest.mark.parametrize("dtype,group,positions", [
    (torch.bfloat16, 4, 32), (torch.float32, 4, 16),
    (torch.bfloat16, 64, 2), (torch.float32, 64, 1)])
def test_paged_res_prefill_tile_positions_by_kernel(dtype, group, positions):
    """#5 in bf16: 128 rows per CTA of its tile; in f32, the template's
    64."""
    assert tpra.tile_positions("paged_residual_attention_prefill", dtype,
                               group, 2048) == positions
