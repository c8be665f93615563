"""The split-K decodes' rank route above rank 64 (``flash::DecodePipe`` in
``csrc/rank_chunk.cuh``), checked on the CPU: #2's
``paged_decode_res_chunk_kernel`` and #8's
``residual_attention_decode_chunk_kernel`` at LoRA ranks from 65 to
``DECODE_RANK_MAX``.  The kernels run on the card only
(``chip_smoke.py``); here are their plan and their arithmetic.

The plan (``residual_attention.decode_chunk_layout`` and the mirrors that
use it): every decode instance a dispatcher can choose, dense and paged,
bf16 and int8 pages, head_dim 32/64/120/128 (and 256 dense), ranks
65/128/256/512, fits the H100's 232,448 bytes per CTA, the rank route's
with at least two ring stages; the largest rank of the route is pinned;
the resident CTAs the plans count on fit an SM; the workspace holds R
columns of acc_r per share.

The arithmetic (``emulate``): per (row, kv head) each CTA walks its keys
in blocks of 64, with K = bf16(K_b + RoPE(sum_c K_r,c . B_k,c)) summed in
f32 chunk by chunk of 64 ranks and rounded once, one online softmax per
CTA over the block's scores (its row maxima meet across the warps), P in
bf16 for P . V_b and P . V_r, O and acc_r in f32; then the CTAs' partials
merge with weights 2^(m - max m), and B_v comes last: out = (O + acc_r .
B_v) / max(l, 1e-20), with acc_r rounded to bf16 there for #8 (its one
range, in the kernel, and its combine) and not for #2 (its combine).  A
CTA of #8 takes one range of 64-key multiples (n_split ranges); a CTA of
#2 the union of its 4 shares of 16-key multiples (``res_split_plan``'s
n_split = 4 CTAs per row).  Held with bf16 inputs to the port's plain
version within 1% of its max |value| (chip_smoke's gate), and with f32
inputs to the JAX package's ``repro.kernels.ref`` and to the port's plain
version within 1e-5, at ranks 65 and 128, one CTA and three per row,
windows 0 and 300, bf16 and int8 pages.  Rows that see no key come out
exactly 0 (the plain versions average V there and are not compared).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.device import SMEM_PER_CTA_RESERVED, SMEM_PER_SM
from repro_torch.kernels import paged_residual_attention as tpra
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_attention as tra
from repro_torch.models.transformer import quantize_kv

H100_SMEM_PER_CTA = 232448
LOG2E = 1.4426950408889634
NEG_INIT = -1e30
BF16_SHARE = 0.01       # chip_smoke's BF16_RTOL
F32_TOL = 1e-5
BLOCK = 64              # keys per block of the route
RANKS = (65, 128)
CTAS = (1, 3)           # CTAs per (row, kv head)
WINDOWS = (0, 300)
DENSE_DIMS = (32, 64, 120, 128, 256)
PAGED_DIMS = (32, 64, 120, 128)
ALL_RANKS = (65, 128, 256, 512)
HQ, HKV, D = 8, 2, 64   # a group of 4
PAGE, WIDTH = 16, 32    # 512 keys of table per paged row
PAGED_KV = [0, 1, 17, 300, 477]
DENSE_SK = 400
DENSE_KV = [400, 261, 1, 0]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("r", ALL_RANKS)
@pytest.mark.parametrize("d", DENSE_DIMS)
def test_dense_decode_instances_fit_the_card(d, r):
    """#8's instance at every head_dim and rank fits a CTA; the rank
    route's ring has at least two stages; the CTAs per SM the plan counts
    on fit together."""
    smem = tra.decode_split_smem(d, r)
    assert smem <= H100_SMEM_PER_CTA
    if tra.decode_route(r):
        plan = tra.decode_chunk_plan(tra.tile_dim(d), r)
        assert plan["stages"] >= 2 and smem == plan["bytes"]
    ctas = tra.decode_ctas_per_sm(d, r)
    assert ctas * (smem + SMEM_PER_CTA_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("int8", (False, True))
@pytest.mark.parametrize("r", ALL_RANKS)
@pytest.mark.parametrize("d", PAGED_DIMS)
def test_paged_decode_instances_fit_the_card(d, r, int8):
    """#2's instance at every head_dim, rank and page type fits a CTA
    beside its block-table slices (2 KB); the rank route's ring has at
    least two stages; the CTAs per SM the plan counts on fit together."""
    smem = tpra.res_split_smem(d, r, int8)
    assert smem + 2048 <= H100_SMEM_PER_CTA
    if tra.decode_route(r):
        plan = tra.decode_chunk_plan(tra.tile_dim(d), r, int8, dense=False)
        assert plan["stages"] >= 2 and smem == plan["bytes"]
    ctas = tpra.res_ctas_per_sm(d, r, int8)
    assert ctas * (smem + SMEM_PER_CTA_RESERVED) <= SMEM_PER_SM


def test_rank_route_limit_is_pinned():
    """The route takes ranks 65..256 at every head_dim (its acc_r
    registers are sized for 256; where a held B_k does not fit it streams,
    which needs no memory that grows with R); above, the rebuild instance
    keeps its layout."""
    assert tra.DECODE_RANK_MAX == 256
    for d in DENSE_DIMS:
        assert tra.decode_rank_max(d) == tra.DECODE_RANK_MAX
    assert [tra.decode_route(r) for r in (1, 64, 65, 256, 257, 512)] == \
        [False, False, True, True, False, False]
    for d, int8 in itertools.product((32, 64, 128), (False, True)):
        rebuild = 2 * 16 * (d + 8) + tra.chunk_block_smem(d, 64, int8)
        assert tpra.res_split_smem(d, 512, int8) == rebuild
        if not int8:
            assert tra.decode_split_smem(d, 512) == rebuild


@pytest.mark.parametrize("d,int8,hold,want,stages,nbytes", [
    (128, False, False, 2, 2, 113408), (128, True, False, 2, 2, 112896),
    (256, False, False, 2, 2, 199424), (256, False, False, 3, 2, 199424),
    (64, False, False, 2, 2, 70400), (64, True, False, 2, 2, 69888),
    (32, False, False, 2, 2, 48896), (32, True, False, 2, 2, 48384),
    (128, False, True, 3, 3, 87808), (128, True, True, 2, 2, 78080),
    (256, False, True, 3, 3, 141056)])
def test_rank_route_layout_bytes(d, int8, hold, want, stages, nbytes):
    """``flash::DecodeChunk``'s bytes at tile width ``d`` without a held
    B_k: Q, P and the warps' maxima, the stages (a 64 x 64 chunk and,
    streamed, 64 rows of B_k; at most ``want``, as many as fit), the
    block's K_b, sin, cos and V_b (int8: codes, scales, V's bf16 tile)."""
    lay = tra.decode_chunk_layout(d, int8, hold, want)
    assert (lay["stages"], lay["bytes"]) == (stages, nbytes)
    assert lay["stage"] == 2 * 64 * 72 + (0 if hold else 2 * 64 * (d + 8))


@pytest.mark.parametrize("d,r,int8,dense,hold,stages,nbytes", [
    (128, 128, False, True, True, 3, 122624),    # #8 at Llama3-8B's heads
    (128, 256, False, True, True, 3, 157440),
    (256, 128, False, True, True, 3, 208640),    # RecurrentGemma-9B's
    (256, 256, False, True, False, 2, 199424),   # B_k held does not fit
    (128, 128, False, False, True, 2, 113408),   # #2: two CTAs per SM
    (128, 128, True, False, True, 2, 112896),
    (128, 192, False, False, False, 2, 113408),  # held leaves one per SM
    (128, 256, True, False, False, 2, 112896),
    (64, 256, False, False, True, 2, 88832)])
def test_each_family_takes_its_plan(d, r, int8, dense, hold, stages,
                                    nbytes):
    """#8 holds B_k with 3 stages where a CTA fits, else streams it with
    2; #2 keeps two CTAs per SM and holds B_k only where they still fit
    (``PAGED_TWO_PER_SM``: half an SM less 1 KB reserved and 2 KB of
    block-table slices)."""
    assert tra.DECODE_HOLD_BK and tra.DECODE_STAGES == 0
    assert tra.PAGED_TWO_PER_SM == 113664
    plan = tra.decode_chunk_plan(d, r, int8, dense)
    assert (plan["hold"], plan["stages"], plan["bytes"]) == \
        (hold, stages, nbytes)
    if not dense:
        assert plan["bytes"] <= tra.PAGED_TWO_PER_SM


def test_rank_route_doubles_the_ctas_of_the_llama_serve():
    """At Llama3-8B's heads #2's CTA (113,408 bytes) leaves room for two
    per SM, so its plan splits each row twice as finely as the rebuild
    instance's one CTA per SM did; #8's holds B_k with 3 stages, one CTA
    per SM."""
    for r in (128, 256):
        assert tpra.res_ctas_per_sm(128, r, False) == 2
        assert tpra.res_ctas_per_sm(128, r, True) == 2
        assert tra.decode_ctas_per_sm(128, r) == 1
    assert tpra.res_split_plan(8, 32, 8, 128, 128, 256, 16, False,
                               132)["n_split"] == 16
    assert tpra.res_ctas_per_sm(128, 512, False) == 1
    assert tra.decode_ctas_per_sm(256, 128) == 1


@pytest.mark.parametrize("r", ALL_RANKS)
def test_workspace_holds_r_columns_per_share(r):
    """Both plans' f32 workspaces carry m, l, D columns of O and R of
    acc_r per share (the rank route's partials; the rebuild instance
    leaves acc_r unwritten and its combine takes no rank)."""
    plan = tra.decode_split_plan(4, 32, 8, 128, r, 4096, 0, 132)
    assert plan["n_split"] > 1
    assert plan["workspace_bytes"] == 4 * 4 * 32 * plan["n_split"] * (
        128 + r + 2)
    plan = tpra.res_split_plan(8, 32, 8, 128, r, 256, 16, True, 132)
    assert plan["workspace_bytes"] == 4 * 8 * 32 * plan["n_split"] * (
        128 + r + 2)


# ------------------------------------------------------- the arithmetic
def bf(x):
    return x.to(torch.bfloat16).float()


def chunk_sums(res, b):
    """res (B, Sk, R) . b (B, R, N) in f32, the rank in chunks of 64
    summed in order."""
    out = 0.0
    for c in range(0, res.shape[-1], tra.RANK_CHUNK):
        out = out + torch.einsum("bsr,brn->bsn",
                                 res[..., c:c + tra.RANK_CHUNK].float(),
                                 b[:, c:c + tra.RANK_CHUNK].float())
    return out


def rebuild_k(base, res, b_k, sin, cos, lowp):
    """K = K_b + RoPE(chunk sums), rounded once to bf16 (``lowp``).
    base (B, Sk, Hkv, D); sin/cos (B, Sk, D/2)."""
    bsz, sk, hkv, d = base.shape
    x = chunk_sums(res, b_k).reshape(bsz, sk, hkv, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    sn, cs = sin.float()[:, :, None], cos.float()[:, :, None]
    k = base.float() + torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn], -1)
    return bf(k) if lowp else k


def walk(qh, k, v, vr, lo, hi, scale, lowp):
    """One CTA over keys [lo, hi) of one (row, kv head): blocks of 64, one
    online softmax in base 2, P rounded to bf16 (``lowp``) for P . V_b and
    P . V_r.  None for an empty range (m -1e30, l 0: weight 0)."""
    if lo >= hi:
        return None
    rnd = bf if lowp else (lambda x: x)
    g = qh.shape[0]
    c = scale * LOG2E
    m, l = torch.full((g,), NEG_INIT), torch.zeros(g)
    acc, accr = torch.zeros(g, v.shape[-1]), torch.zeros(g, vr.shape[-1])
    for j0 in range(lo, hi, BLOCK):
        sl = slice(j0, min(j0 + BLOCK, hi))
        s = qh @ k[sl].T
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[:, None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + rnd(p) @ v[sl]
        accr = accr * alpha[:, None] + rnd(p) @ vr[sl]
        m = m_new
    return m, l, acc, accr


def finish(parts, b_v, round_accr):
    """The CTAs' partials merged (weights 2^(m - max m) over those with l
    > 0), then (O + acc_r . B_v) / max(l, 1e-20), acc_r rounded to bf16
    first where ``round_accr``; zeros where no CTA saw a key."""
    seen = [pt for pt in parts if pt is not None]
    if not seen:
        return torch.zeros(1, b_v.shape[-1])
    mx = torch.stack([pt[0] for pt in seen]).amax(0)
    w = [torch.exp2(pt[0] - mx)[:, None] for pt in seen]
    lsum = sum(wi[:, 0] * pt[1] for wi, pt in zip(w, seen))
    acc = sum(wi * pt[2] for wi, pt in zip(w, seen))
    accr = sum(wi * pt[3] for wi, pt in zip(w, seen))
    if round_accr:
        accr = bf(accr)
    return (acc + accr @ b_v) / torch.clamp(lsum, min=1e-20)[:, None]


def emulate(q, k, v, vr, b_v, ranges, scale, lowp, round_accr):
    """q (B, Hq, D); k, v (B, Sk, Hkv, D); vr (B, Sk, R); b_v (B, R,
    Hkv * D); ranges[b]: the CTAs' [lo, hi) of row b.  Returns (B, Hq,
    D) f32."""
    bsz, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    b_v = b_v.float().reshape(bsz, -1, hkv, d)
    out = torch.zeros(bsz, hq, d)
    for b, h in itertools.product(range(bsz), range(hkv)):
        qh = q[b, h * g:(h + 1) * g].float()
        parts = [walk(qh, k[b, :, h], v[b, :, h].float(), vr[b].float(), lo,
                      hi, scale, lowp) for lo, hi in ranges[b]]
        out[b, h * g:(h + 1) * g] = finish(parts, b_v[b, :, h], round_accr)
    return out


def dense_ranges(kv_len, window, ctas):
    """#8's ranges (``Range``): the live keys [max(kv_len - window, 0),
    kv_len) in ``ctas`` equal ranges of whole 64-key multiples."""
    first = max(kv_len - window, 0) if window else 0
    per = -(-(-(-(kv_len - first) // ctas)) // BLOCK) * BLOCK
    return [(min(kv_len, first + s * per),
             min(kv_len, min(kv_len, first + s * per) + per))
            for s in range(ctas)]


def paged_ranges(kv_len, window, ctas):
    """#2's CTAs: each the union of its 4 shares of 16-key multiples
    (``Share`` with n_split = 4 ctas), clipped to the row's keys."""
    n_split = tpra.RES_SPLIT_WARPS * ctas
    end = min(kv_len, WIDTH * PAGE)
    first = max(0, kv_len - window) if window else 0
    n = max(0, end - first)
    per = -(-(-(-n // n_split)) // tpra.RES_SPLIT_KEYS) * \
        tpra.RES_SPLIT_KEYS
    out = []
    for s in range(0, n_split, tpra.RES_SPLIT_WARPS):
        lo = first + s * per
        out.append((lo, min(lo + tpra.RES_SPLIT_WARPS * per, end)))
    return out


def test_ranges_cover_the_live_keys_once():
    """Both families' CTA ranges tile each row's live keys exactly, every
    range but the last a whole number of 64-key blocks for #8."""
    for kv, window, ctas in itertools.product(
            range(0, 700, 37), (0, 1, 64, 300), (1, 2, 3, 7)):
        for fn, keys in ((dense_ranges, BLOCK),
                         (paged_ranges, tpra.RES_SPLIT_KEYS)):
            got = fn(min(kv, WIDTH * PAGE), window, ctas)
            end = min(kv, WIDTH * PAGE)
            first = max(0, end - window) if window else 0
            assert [k for lo, hi in got for k in range(lo, hi)] == \
                list(range(first, end))
            full = [hi - lo for lo, hi in got if hi > lo][:-1]
            assert all(n % keys == 0 for n in full)


# ---------------------------------------------- #8 over a contiguous cache
def dense_inputs(seed, r):
    """B 4 rows over a cache of DENSE_SK keys (kv_len DENSE_KV), Hkv 2, G
    4, D 64, RoPE tables of positions 0..Sk-1."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz, sk = len(DENSE_KV), DENSE_SK
    inv = 1.0 / (10_000.0 ** (np.arange(D // 2, dtype=np.float32) / (D // 2)))
    ang = np.arange(sk, dtype=np.float32)[:, None] * inv
    tab = lambda x: np.broadcast_to(x, (bsz, sk, D // 2)).copy()  # noqa
    return dict(q=f(bsz, HQ, D), k_base=f(bsz, sk, HKV, D),
                v_base=f(bsz, sk, HKV, D), k_res=f(bsz, sk, r) * 0.3,
                v_res=f(bsz, sk, r) * 0.3, b_k=f(bsz, r, HKV * D) * 0.3,
                b_v=f(bsz, r, HKV * D) * 0.3, sin=tab(np.sin(ang)),
                cos=tab(np.cos(ang)), kv_len=np.asarray(DENSE_KV, np.int32))


_DENSE = ("k_base", "v_base", "k_res", "v_res", "b_k", "b_v", "sin", "cos")


def emulate_dense(t, window, ctas, lowp):
    k = rebuild_k(t["k_base"], t["k_res"], t["b_k"], t["sin"], t["cos"],
                  lowp)
    ranges = [dense_ranges(int(kv), window, ctas) for kv in t["kv_len"]]
    return emulate(t["q"], k, t["v_base"], t["v_res"], t["b_v"], ranges,
                   D ** -0.5, lowp, round_accr=lowp)


def dense_plain(t, window):
    qpos = (t["kv_len"].long() - 1).clamp(min=0)[:, None]
    return tref.residual_attention_ref(
        t["q"][:, None], *[t[k] for k in _DENSE], qpos=qpos,
        kv_len=t["kv_len"], window=window)[:, 0].float()


def seen(kv_len):
    return torch.as_tensor(np.asarray(kv_len)) > 0


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("r", RANKS)
def test_dense_route_holds_the_bf16_gate(r, ctas, window):
    t = {k: torch.from_numpy(v) for k, v in dense_inputs(50 + r, r).items()}
    t = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
         for k, v in t.items()}
    got = emulate_dense(t, window, ctas, lowp=True)
    want = dense_plain(t, window)
    rows = seen(DENSE_KV)
    assert torch.all(got[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= BF16_SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("r", RANKS)
def test_dense_route_matches_jax_and_the_plain_version_in_f32(r, ctas,
                                                              window):
    inp = dense_inputs(60 + r, r)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = emulate_dense(t, window, ctas, lowp=False).numpy()
    rows = seen(DENSE_KV).numpy()
    qpos = np.maximum(inp["kv_len"] - 1, 0)[:, None].astype(np.int32)
    want = np.asarray(jref.residual_attention_ref(
        jnp.asarray(inp["q"][:, None]), *[jnp.asarray(inp[k])
                                          for k in _DENSE],
        qpos=jnp.asarray(qpos), kv_len=jnp.asarray(inp["kv_len"]),
        window=window))[:, 0]
    np.testing.assert_allclose(got[rows], want[rows], atol=F32_TOL,
                               rtol=F32_TOL)
    plain = dense_plain(t, window).numpy()
    np.testing.assert_allclose(got[rows], plain[rows], atol=F32_TOL,
                               rtol=F32_TOL)


# -------------------------------------------------------- #2 over pages
def paged_inputs(seed, r):
    """Rows at kv_len PAGED_KV over block tables WIDTH pages wide into
    shuffled pools (base and residual, each its own table), per-row
    B_k/B_v."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = len(PAGED_KV)
    pool, pool_r = bsz * WIDTH + 3, bsz * WIDTH + 5
    table = lambda n: rng.permutation(n)[:bsz * WIDTH].reshape(  # noqa
        bsz, WIDTH).astype(np.int32)
    return dict(q=f(bsz, HQ, D), kb=f(pool, PAGE, HKV, D),
                vb=f(pool, PAGE, HKV, D), kr=f(pool_r, PAGE, r) * 0.3,
                vr=f(pool_r, PAGE, r) * 0.3, b_k=f(bsz, r, HKV * D) * 0.3,
                b_v=f(bsz, r, HKV * D) * 0.3, bt_b=table(pool),
                bt_r=table(pool_r), kv_len=np.asarray(PAGED_KV, np.int32))


_PAGED = ("q", "kb", "vb", "kr", "vr", "b_k", "b_v", "bt_b", "bt_r",
          "kv_len")


def paged_case(seed, r, pages):
    t = {k: torch.from_numpy(v) for k, v in paged_inputs(seed, r).items()}
    if pages != "f32":
        for k in ("q", "kb", "vb", "kr", "vr", "b_k", "b_v"):
            t[k] = t[k].to(torch.bfloat16)
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    return t, ks, vs


def emulate_paged(t, window, ctas, lowp, ks=None, vs=None):
    """#2 at the wrapper's RoPE table (q's type); int8 pages dequantized
    to bf16(code * scale) first, as the kernel and the plain version do."""
    bsz = t["q"].shape[0]
    sk = WIDTH * PAGE
    bt, btr = t["bt_b"].long(), t["bt_r"].long()

    def gather(pool, sc):
        x = pool[bt].reshape(bsz, sk, HKV, D)
        if sc is not None:
            x = (x.float() * sc[bt].reshape(bsz, sk, HKV)[..., None]).to(
                t["q"].dtype)
        return x

    table = tpra.rope_table(torch.device("cpu"), D, 10_000.0, t["q"].dtype,
                            sk)
    sin, cos = (table[i, :sk][None].expand(bsz, sk, D // 2) for i in (0, 1))
    kr = t["kr"][btr].reshape(bsz, sk, -1)
    vr = t["vr"][btr].reshape(bsz, sk, -1)
    k = rebuild_k(gather(t["kb"], ks), kr, t["b_k"], sin, cos, lowp)
    ranges = [paged_ranges(int(kv), window, ctas) for kv in t["kv_len"]]
    return emulate(t["q"], k, gather(t["vb"], vs), vr, t["b_v"], ranges,
                   D ** -0.5, lowp, round_accr=False)


@pytest.mark.parametrize("pages", ("bf16", "int8"))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("r", RANKS)
def test_paged_route_holds_the_bf16_gate(r, ctas, window, pages):
    t, ks, vs = paged_case(70 + r, r, pages)
    got = emulate_paged(t, window, ctas, lowp=True, ks=ks, vs=vs)
    want = tref.paged_residual_attention_ref(
        *[t[k] for k in _PAGED], window=window, kb_scale=ks,
        vb_scale=vs).float()
    rows = seen(PAGED_KV)
    assert torch.all(got[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= BF16_SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("r", RANKS)
def test_paged_route_matches_jax_and_the_plain_version_in_f32(r, ctas,
                                                              window):
    t, _, _ = paged_case(80 + r, r, "f32")
    got = emulate_paged(t, window, ctas, lowp=False).numpy()
    rows = seen(PAGED_KV).numpy()
    want = np.asarray(jref.paged_residual_attention_ref(
        *[jnp.asarray(t[k].numpy()) for k in _PAGED], window=window))
    np.testing.assert_allclose(got[rows], want[rows], atol=F32_TOL,
                               rtol=F32_TOL)
    plain = tref.paged_residual_attention_ref(
        *[t[k] for k in _PAGED], window=window).numpy()
    np.testing.assert_allclose(got[rows], plain[rows], atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("r", RANKS)
def test_one_cta_and_three_agree(r):
    """The CTAs' merge moves the result only by f32 summation order (the
    same blocks at other offsets, bf16 rounding of P at other maxima): the
    emulation at 1 and 3 CTAs per row within the bf16 gate of each other."""
    t = {k: torch.from_numpy(v) for k, v in dense_inputs(90 + r, r).items()}
    t = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
         for k, v in t.items()}
    one, three = (emulate_dense(t, 0, n, lowp=True) for n in (1, 3))
    assert (one - three).abs().max().item() <= \
        BF16_SHARE * one.abs().max().item()
