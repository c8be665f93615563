"""The split-K decode's algorithm (#4, ``paged_attention_decode_base``),
checked on the CPU.

Every launch of the base-only paged decode on the card runs the split-K
kernel of ``paged_residual_attention.cu``: each row's live keys, [kv_len -
window, kv_len) clipped to [0, min(kv_len, W * page)), are cut into
``n_split`` equal shares of whole 64-key multiples; each share yields f32
partials (m in base 2, l, acc) and a second kernel combines them.
``emulate`` below repeats that in plain torch, in this test only, with the
kernel's arithmetic: q scaled by scale * log2(e) in f32, int8 pages
dequantized as (code * scale) in f32 rounded to q's type, all sums f32,
and a share with no key giving m = -1e30, l = 0 and weight 0 in the
combine, so a row at kv_len 0 comes out exactly 0 (the plain version
averages V there; such rows are not compared).

With bf16 q (bf16 or int8 pages) it is held to the port's plain version
within 0.5% of the plain version's max |value|, half the 1% that
``chip_smoke.py`` holds the kernel to; with f32 inputs to the JAX
package's ``repro.kernels.ref`` within 1e-5.  Rows: kv_len 0, 1, a
non-multiple of the page and a long row; n_split 1, 3 and 7 (7 leaves
shares empty); windows 0 and 77, which straddles shares; heads Hq 8 over
Hkv 2 at D 64, over Hkv 4 at D 32 (``tiny_serving_model()`` at its
defaults: G 2, rank 8), and over Hkv 2 at D 120 (h2o-danube-3-4b's head
dim, in the kernels' columns: #4's in order with the last lane of a key
idle, ``in_order``; #2's group tile in the split-half layout,
``split_halves``).  Also pages above 32 tokens (``sub_pages``).  Also ``decode_splits`` and ``split_heads``, the
wrapper's launch plan, and the head/page geometry the wrappers take
(``check_heads``, ``tile_rows``).

The split-K decode with the residual stream (#2,
``paged_residual_attention_decode``) is held the same way by
``emulate_res``: shares of ``RES_SPLIT_KEYS`` multiples, each stepping
through 16 keys at a time as a warp does: K = K_b + RoPE(K_r . B_k) in f32
with sin/cos from the wrapper's ``rope_table``, rounded once to bf16 (int8
pages: bf16(code * scale) first); the online softmax in base 2 with P
rounded to bf16 for P . V_b and P . V_r; f32 partials m, l, acc and acc_r;
and B_v applied after the combine, (sum w acc + (sum w acc_r) . B_v) / max(
sum w l, 1e-20), so a row at kv_len 0 is exactly 0.  In f32 nothing is
rounded and it is held to ``repro.kernels.ref`` within 1e-5 (the f32
kernel is the template share by share, the same algorithm).  Also
``res_split_plan``, its launch plan.

The dense decode (#8, ``residual_attention_decode``) in bf16 runs a split-K
decode over a contiguous cache, held the same way by ``emulate_dense``:
the row's live keys in n_split ranges of 64-key multiples, one per CTA,
each warp of a CTA taking every fourth 16-key step of its range with an
online softmax of its own (K rebuilt with the caller's sin/cos, rounded
once to bf16; P in bf16), the CTA's warps merged, then the ranges (in the
kernel itself with one range, the main path's Sk 1; by a combine with
several), and out = (acc + bf16(acc_r) . B_v) / max(l, 1e-20); D 64, 128
and 256 with groups of 4 and 16, D 32 with a group of 2 (where a warp
finishes one n-tile of 8 columns), n_split 1, 3 and 7, Sk 1, 45 and 230,
windows 0 and 77; with bf16 inputs held within 0.5% to the plain version
evaluated in f32 on them (its bf16 evaluation rounds scores and P and
moves up to ~0.7% at D 256 on rows of a few dozen keys), and with f32
inputs to ``repro.kernels.ref`` within 1e-5.  Also ``decode_split_plan``,
including the one-range case that skips the combine.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import paged_residual_attention as tpra
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_attention as tra
from repro_torch.models.transformer import quantize_kv

LOG2E = 1.4426950408889634
NEG_INIT = -1e30
SHARE = 0.005        # half of chip_smoke's BF16_RTOL
HQ, HKV, D, PAGE = 8, 2, 64, 16
RANK = 16
# head_dim 32 with a group of 2 at rank 8: tiny_serving_model() at its
# defaults; ``None`` is the module's HQ/HKV/D at RANK
D32 = dict(hq=8, hkv=4, d=32, rank=8)
# head_dim 120 (h2o-danube-3-4b's) with its group of 4: #4 runs it in D
# 128's lane map, the columns in order and the last lane of a key idle;
# #2 in D 128's group tile in the split-half layout
D120 = dict(hq=8, hkv=2, d=120, rank=16)
KV_LEN = [0, 1, 45, 230]      # 45: not a multiple of the page
WIDTH = 16                    # 256 keys of table per row
SPLITS = (1, 3, 7)
WINDOWS = (0, 77)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def heads(geom):
    """(Hq, Hkv, D, R) of ``geom`` (None: the module's)."""
    g = geom or dict(hq=HQ, hkv=HKV, d=D, rank=RANK)
    return g["hq"], g["hkv"], g["d"], g["rank"]


def pages_and_heads(*pages):
    """``pages`` at the module's heads (ids as before), at ``D32`` and at
    ``D120``."""
    return [pytest.param(p, None, id=p) for p in pages] + \
        [pytest.param(p, D32, id=f"{p}-d32-g2") for p in pages] + \
        [pytest.param(p, D120, id=f"{p}-d120-g4") for p in pages]


def in_order(x, d):
    """#4's columns: the head's in order, then zeros to the tile's width
    (the idle lanes)."""
    return torch.nn.functional.pad(x, (0, tra.tile_dim(d) - d))


def split_halves(x, d):
    """#2's group tile: the halves at tile columns 0.. and tile_dim/2..,
    the gap columns zero (``tra.tile_columns``)."""
    out = torch.zeros(x.shape[:-1] + (tra.tile_dim(d),), dtype=x.dtype)
    out[..., tra.tile_columns(d)] = x
    return out


def inputs(seed, geom=None):
    hq, hkv, d, _ = heads(geom)
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = len(KV_LEN)
    pool = bsz * WIDTH + 3
    bt = rng.permutation(pool)[:bsz * WIDTH].reshape(bsz, WIDTH)
    return dict(q=f(bsz, hq, d), kb=f(pool, PAGE, hkv, d),
                vb=f(pool, PAGE, hkv, d), bt_b=bt.astype(np.int32),
                kv_len=np.asarray(KV_LEN, np.int32))


def live_range(kv_len, width, window):
    """The keys a decode row reads: [kv_len - window, kv_len) clipped to
    [0, min(kv_len, W * page))."""
    end = min(kv_len, width * PAGE)
    first = max(0, kv_len - window) if window else 0
    return first, end


def shares(first, end, n_split):
    """[lo, hi) of each split: equal shares in whole 64-key multiples."""
    n = max(0, end - first)
    per = -(-(-(-n // n_split)) // tpra.SPLIT_KEYS) * tpra.SPLIT_KEYS
    return [(first + s * per, min(end, first + (s + 1) * per))
            for s in range(n_split)]


def emulate(t, n_split, window, ks=None, vs=None):
    """The split-K decode: per (row, kv head), partials over each share,
    then the combine.  t: q (B, Hq, D), kb/vb (P, page, Hkv, D), bt_b,
    kv_len.  Returns the f32 output (B, Hq, D)."""
    q = t["q"]
    bsz, hq, d = q.shape
    hkv = t["kb"].shape[2]
    g = hq // hkv
    width = t["bt_b"].shape[1]
    bt = t["bt_b"].long()

    def gather(pool, sc):
        x = pool[bt].reshape(bsz, width * PAGE, hkv, d)
        if sc is not None:
            x = (x.float() * sc[bt].reshape(bsz, -1, hkv)[..., None]).to(
                q.dtype)
        return x.float()

    # in the kernel's columns (``in_order``); the real ones come back
    k, v = in_order(gather(t["kb"], ks), d), in_order(gather(t["vb"], vs), d)
    qs = in_order(q.float(), d) * (d ** -0.5 * LOG2E)
    w = tra.tile_dim(d)
    out = torch.zeros(bsz, hq, w)
    for b in range(bsz):
        first, end = live_range(int(t["kv_len"][b]), width, window)
        for h in range(hkv):
            qh = qs[b, h * g:(h + 1) * g]                   # (G, D)
            parts = []
            for lo, hi in shares(first, end, n_split):
                if lo >= hi:
                    parts.append((torch.full((g,), NEG_INIT),
                                  torch.zeros(g), None))
                    continue
                s = qh @ k[b, lo:hi, h].T                   # (G, keys)
                m = s.amax(-1)
                p = torch.exp2(s - m[:, None])
                parts.append((m, p.sum(-1), p @ v[b, lo:hi, h]))
            seen = [pt for pt in parts if pt[2] is not None]
            if not seen:
                continue                  # l = 0 everywhere: exactly 0
            mx = torch.stack([pt[0] for pt in seen]).amax(0)
            lsum = sum(torch.exp2(m - mx) * l for m, l, _ in seen)
            acc = sum(torch.exp2(m - mx)[:, None] * a for m, _, a in seen)
            out[b, h * g:(h + 1) * g] = acc / torch.clamp(lsum, min=1e-20)[
                :, None]
    return out[..., :d]


def seen_rows():
    return torch.tensor(KV_LEN) > 0


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages,geom", pages_and_heads("bf16", "int8"))
def test_splitk_holds_half_the_bf16_gate(pages, geom, n_split, window):
    t = {k: torch.from_numpy(v) for k, v in inputs(21, geom).items()}
    for k in ("q", "kb", "vb"):
        t[k] = t[k].to(torch.bfloat16)
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    want = tref.paged_residual_attention_ref(
        t["q"], t["kb"], t["vb"], None, None, None, None, t["bt_b"], None,
        t["kv_len"], window=window, kb_scale=ks, vb_scale=vs).float()
    got = emulate(t, n_split, window, ks, vs)
    rows = seen_rows()
    assert torch.all(got[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages,geom", pages_and_heads("f32", "int8"))
def test_splitk_matches_jax_in_f32(pages, geom, n_split, window):
    t = {k: torch.from_numpy(v) for k, v in inputs(22, geom).items()}
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    got = emulate(t, n_split, window, ks, vs).numpy()
    j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa
    want = np.asarray(jref.paged_residual_attention_ref(
        j(t["q"]), j(t["kb"]), j(t["vb"]), None, None, None, None,
        j(t["bt_b"]), None, j(t["kv_len"]), window=window, kb_scale=j(ks),
        vb_scale=j(vs)))
    rows = seen_rows().numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)


def test_shares_cover_the_live_range_once():
    """The shares tile each row's live range exactly, in 64-key
    multiples, with the empty ones at the end."""
    for kv_len in (0, 1, 45, 230, 256, 300):
        for window in (0, 77, 300):
            first, end = live_range(kv_len, WIDTH, window)
            for n_split in (1, 2, 3, 7, 64):
                got = shares(first, end, n_split)
                keys = [k for lo, hi in got for k in range(lo, hi)]
                assert keys == list(range(first, end))
                full = [hi - lo for lo, hi in got if hi > lo][:-1]
                assert all(n % tpra.SPLIT_KEYS == 0 for n in full)


@pytest.mark.parametrize("bsz,groups,w,page", [
    (8, 8, 256, 16),      # Llama3-8B's heaviest decode: 8 rows, 8 kv heads
    (8, 8, 133, 16),
    (1, 8, 2048, 16),     # one long row
    (1, 1, 1, 16),        # one page
    (64, 8, 10, 16),      # more CTAs than the card holds at once
    (3, 16, 40, 8),
])
def test_decode_splits_stay_in_bounds(bsz, groups, w, page):
    n = tpra.decode_splits(bsz, groups, w, page, 132, heads=4)
    assert 1 <= n <= -(-w * page // tpra.SPLIT_KEYS)
    # one pass of the card's resident slots, unless one split per row
    # already exceeds it
    assert n == 1 or n * bsz * groups <= tpra.SPLIT_CTAS_PER_SM[4] * 132
    wide = tpra.decode_splits(bsz, groups, w, page, 132, heads=8)
    assert 1 <= wide <= n
    assert wide == 1 or wide * bsz * groups <= tpra.SPLIT_CTAS_PER_SM[8] * 132


def test_decode_splits_fill_the_card():
    """Two or more waves of CTAs (one per SM) at the heaviest decode, and
    many splits for one long row."""
    heavy = tpra.decode_splits(8, 8, 256, 16, 132, heads=4)
    assert heavy * 8 * 8 >= 2 * 132
    assert tpra.decode_splits(1, 8, 2048, 16, 132, heads=4) >= 32


@pytest.mark.parametrize("group,heads,ctas", [
    (1, 1, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1), (6, 8, 1), (8, 8, 1),
    (12, 8, 2), (64, 8, 8)])
def test_split_heads_tile_the_group(group, heads, ctas):
    """Query heads per CTA: the group rounded up to a power of two, at
    most 8; a group of 64 heads takes 8 CTAs per kv head."""
    assert tpra.split_heads(group) == heads
    plan = tpra.split_plan(2, group * 2, 2, 128, 64, 16, 132)
    assert plan["grid"][1] == 2 * ctas
    assert plan["workspace_bytes"] == 4 * 2 * group * 2 * \
        plan["n_split"] * (128 + 2)


# ------------------------------------------------- with the residual stream
def res_inputs(seed, geom=None):
    """``inputs`` plus residual pools (Pr, page, R) addressed by their own
    block table, and per-row B_k/B_v (B, R, Hkv * D)."""
    t = inputs(seed, geom)
    _, hkv, d, r = heads(geom)
    rng = np.random.default_rng(seed + 100)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = len(KV_LEN)
    pool_r = bsz * WIDTH + 5
    t.update(kr=f(pool_r, PAGE, r) * 0.3, vr=f(pool_r, PAGE, r) * 0.3,
             b_k=f(bsz, r, hkv * d) * 0.3, b_v=f(bsz, r, hkv * d) * 0.3,
             bt_r=rng.permutation(pool_r)[:bsz * WIDTH].reshape(
                 bsz, WIDTH).astype(np.int32))
    return t


def res_shares(first, end, n_split):
    """[lo, hi) of each share: equal shares in whole RES_SPLIT_KEYS
    multiples."""
    n = max(0, end - first)
    per = -(-(-(-n // n_split)) // tpra.RES_SPLIT_KEYS) * tpra.RES_SPLIT_KEYS
    return [(first + s * per, min(end, first + (s + 1) * per))
            for s in range(n_split)]


def rebuilt_k(t, ks, lowp):
    """(B, W * page, Hkv, tile) f32 in the group tile's columns
    (``split_halves``): K = K_b + RoPE(K_r . B_k), sin/cos from the
    wrapper's table in q's type (zero past its d/2 columns); rounded once
    to bf16 (``lowp``)."""
    q = t["q"]
    bsz, width = t["bt_b"].shape
    hkv, d = t["kb"].shape[2:]
    w = tra.tile_dim(d)
    sk = width * PAGE
    bt, btr = t["bt_b"].long(), t["bt_r"].long()
    kb = t["kb"][bt].reshape(bsz, sk, hkv, d)
    if ks is not None:
        kb = (kb.float() * ks[bt].reshape(bsz, sk, hkv)[..., None]).to(
            q.dtype)
    kb = split_halves(kb, d)
    kr = t["kr"][btr].reshape(bsz, sk, -1).float()
    b_k = split_halves(t["b_k"].float().reshape(bsz, -1, hkv, d), d)
    kl = torch.einsum("bsr,brn->bsn", kr, b_k.reshape(bsz, -1, hkv * w)
                      ).reshape(bsz, sk, hkv, w)
    table = tpra.rope_table(torch.device("cpu"), d, 10_000.0, q.dtype, sk)
    sn, cs = (torch.nn.functional.pad(table[i, :sk].float(), (
        0, (w - d) // 2))[None, :, None] for i in (0, 1))
    x1, x2 = kl[..., :w // 2], kl[..., w // 2:]
    k = kb.float() + torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn], -1)
    return k.to(torch.bfloat16).float() if lowp else k


def emulate_res(t, n_split, window, ks=None, vs=None, lowp=True):
    """The split-K decode with the residual stream: per (row, kv head),
    each share's partials from 16-key steps of an online softmax, then the
    combine with B_v.  Returns the f32 output (B, Hq, D)."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if lowp else \
        (lambda x: x)
    bsz, hq, d = t["q"].shape
    q = split_halves(t["q"], d)                     # the group tile's columns
    hkv = t["kb"].shape[2]
    g = hq // hkv
    width = t["bt_b"].shape[1]
    k = rebuilt_k(t, ks, lowp)
    bt, btr = t["bt_b"].long(), t["bt_r"].long()
    v = t["vb"][bt].reshape(bsz, width * PAGE, hkv, d)
    if vs is not None:
        v = (v.float() * vs[bt].reshape(bsz, -1, hkv)[..., None]).to(
            t["q"].dtype)
    v = split_halves(v.float(), d)
    vr = t["vr"][btr].reshape(bsz, width * PAGE, -1).float()
    b_v = split_halves(t["b_v"].float().reshape(bsz, -1, hkv, d), d)
    c = d ** -0.5 * LOG2E
    tw = tra.tile_dim(d)
    out = torch.zeros(bsz, hq, tw)
    for b in range(bsz):
        first, end = live_range(int(t["kv_len"][b]), width, window)
        for h in range(hkv):
            qh = q[b, h * g:(h + 1) * g].float()                # (G, D)
            parts = []
            for lo, hi in res_shares(first, end, n_split):
                if lo >= hi:
                    continue                # m = -1e30, l = 0: weight 0
                m = torch.full((g,), NEG_INIT)
                l = torch.zeros(g)
                acc, accr = torch.zeros(g, tw), torch.zeros(g,
                                                            vr.shape[-1])
                for k0 in range(lo, hi, tpra.RES_SPLIT_KEYS):
                    sl = slice(k0, min(k0 + tpra.RES_SPLIT_KEYS, hi))
                    s = qh @ k[b, sl, h].T                      # (G, keys)
                    m_new = torch.maximum(m, s.amax(-1) * c)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s * c - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + rnd(p) @ v[b, sl, h]
                    accr = accr * alpha[:, None] + rnd(p) @ vr[b, sl]
                    m = m_new
                parts.append((m, l, acc, accr))
            if not parts:
                continue                    # l = 0 everywhere: exactly 0
            mx = torch.stack([pt[0] for pt in parts]).amax(0)
            w = [torch.exp2(pt[0] - mx)[:, None] for pt in parts]
            lsum = sum(wi[:, 0] * pt[1] for wi, pt in zip(w, parts))
            acc = sum(wi * pt[2] for wi, pt in zip(w, parts))
            accr = sum(wi * pt[3] for wi, pt in zip(w, parts))
            o = acc + accr @ b_v[b, :, h]
            out[b, h * g:(h + 1) * g] = o / torch.clamp(lsum, min=1e-20)[
                :, None]
    return out[..., tra.tile_columns(d)]


_RES = ("kr", "vr", "b_k", "b_v")


def res_case(seed, pages, lowp, geom=None):
    t = {k: torch.from_numpy(v) for k, v in res_inputs(seed, geom).items()}
    if lowp:
        for k in ("q", "kb", "vb") + _RES:
            t[k] = t[k].to(torch.bfloat16)
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    return t, ks, vs


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages,geom", pages_and_heads("bf16", "int8"))
def test_res_splitk_holds_half_the_bf16_gate(pages, geom, n_split, window):
    t, ks, vs = res_case(23, pages, lowp=True, geom=geom)
    want = tref.paged_residual_attention_ref(
        t["q"], t["kb"], t["vb"], t["kr"], t["vr"], t["b_k"], t["b_v"],
        t["bt_b"], t["bt_r"], t["kv_len"], window=window, kb_scale=ks,
        vb_scale=vs).float()
    got = emulate_res(t, n_split, window, ks, vs)
    rows = seen_rows()
    assert torch.all(got[~rows] == 0.0)
    err = (got - want)[rows].abs().max().item()
    assert err <= SHARE * want[rows].abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages,geom", pages_and_heads("f32", "int8"))
def test_res_splitk_matches_jax_in_f32(pages, geom, n_split, window):
    t, ks, vs = res_case(24, pages, lowp=False, geom=geom)
    got = emulate_res(t, n_split, window, ks, vs, lowp=False).numpy()
    j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa
    want = np.asarray(jref.paged_residual_attention_ref(
        *[j(t[k]) for k in ("q", "kb", "vb") + _RES + ("bt_b", "bt_r",
                                                      "kv_len")],
        window=window, kb_scale=j(ks), vb_scale=j(vs)))
    rows = seen_rows().numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)


def test_res_shares_cover_the_live_range_once():
    """#2's shares tile each row's live range exactly, in 16-key
    multiples, with the empty ones at the end."""
    for kv_len in (0, 1, 17, 45, 230, 256, 300):
        for window in (0, 77, 300):
            first, end = live_range(kv_len, WIDTH, window)
            for n_split in (1, 3, 4, 8, 64):
                got = res_shares(first, end, n_split)
                keys = [k for lo, hi in got for k in range(lo, hi)]
                assert keys == list(range(first, end))
                full = [hi - lo for lo, hi in got if hi > lo][:-1]
                assert all(n % tpra.RES_SPLIT_KEYS == 0 for n in full)


@pytest.mark.parametrize("d,r,int8,ctas", [
    (128, 16, False, 1), (128, 32, False, 1), (128, 16, True, 2),
    (128, 32, True, 1), (64, 16, False, 3), (64, 16, True, 3),
    (32, 8, False, 3), (32, 8, True, 3), (32, 32, False, 3)])
def test_res_split_smem_fits_the_card(d, r, int8, ctas):
    """Each instance's shared memory fits a CTA of the H100 (227 KB), and
    as many CTAs per SM as the plan counts on fit together."""
    smem = tpra.res_split_smem(d, r, int8)
    assert smem + 2048 <= 227 * 1024
    assert tpra.res_ctas_per_sm(d, r, int8) == ctas
    assert ctas * (smem + tpra.SMEM_PER_CTA_RESERVED) <= tpra.SMEM_PER_SM


@pytest.mark.parametrize("bsz,hq,hkv,d,w,page,int8", [
    (8, 32, 8, 128, 256, 16, False),   # Llama3-8B's heaviest decode
    (8, 32, 8, 128, 133, 16, True),
    (1, 32, 8, 128, 2048, 16, False),  # one long row
    (1, 2, 2, 64, 1, 16, False),       # one page
    (64, 32, 8, 128, 10, 16, False),   # more CTAs than the card holds
    (3, 64, 1, 64, 40, 8, True),       # a group of 64: 4 head tiles
    (8, 8, 4, 32, 24, 16, False),      # tiny_serving_model(): D 32, G 2
    (8, 8, 4, 32, 24, 16, True),
])
def test_res_split_plan_stays_in_bounds(bsz, hq, hkv, d, w, page, int8):
    plan = tpra.res_split_plan(bsz, hq, hkv, d, RANK, w, page, int8, 132)
    n, (cta_splits, groups, rows) = plan["n_split"], plan["grid"]
    assert n == cta_splits * tpra.RES_SPLIT_WARPS and rows == bsz
    assert groups == hkv * -(-(hq // hkv) // tpra.RES_SPLIT_HEADS)
    assert 1 <= cta_splits <= -(-w * page // (4 * tpra.RES_SPLIT_KEYS))
    # one pass of the card's resident slots, unless one CTA per row and
    # head tile already exceeds it
    assert cta_splits == 1 or \
        cta_splits * bsz * groups <= plan["ctas_per_sm"] * 132
    assert plan["workspace_bytes"] == 4 * bsz * hq * n * (d + RANK + 2)
    assert plan["combine_grid"] == bsz * hq


def test_res_split_plan_fills_the_card():
    """At the heaviest decode (8 rows x 8 kv heads) the CTAs fill the
    card's resident slots; one long row takes many shares."""
    heavy = tpra.res_split_plan(8, 32, 8, 128, RANK, 256, 16, False, 132)
    assert heavy["grid"][0] * 8 * 8 > 132 // 2
    long = tpra.res_split_plan(1, 32, 8, 128, RANK, 2048, 16, False, 132)
    assert long["n_split"] >= 32


# ------------------------------------------------------ dense decode (#8)
# (D, G): head dims 64/128/256 with groups of 4 (Llama3-8B's) and 16
# (RecurrentGemma-9B's, one whole m16 tile), two kv heads each
DENSE_HEADS = [(d, g) for d in (64, 128, 256) for g in (4, 16)] + [(32, 2)] \
    + [(120, 4)]          # h2o-danube-3-4b's head_dim and group
DENSE_SK = (1, 45, 230)


def dense_inputs(seed, d, g, sk):
    """A contiguous disaggregated cache (B 2, Sk keys, Hkv 2) with RoPE
    tables of positions 0..Sk-1; rows at kv_len Sk and Sk - 13 (at Sk 1
    kv_len is None, as ``forward`` at one token passes it)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz, hkv = 2, 2
    inv = 1.0 / (10_000.0 ** (np.arange(d // 2, dtype=np.float32) /
                              (d // 2)))
    ang = np.arange(sk, dtype=np.float32)[:, None] * inv
    tab = lambda x: np.broadcast_to(x, (bsz, sk, d // 2)).copy()  # noqa
    return dict(
        q=f(bsz, g * hkv, d), k_base=f(bsz, sk, hkv, d),
        v_base=f(bsz, sk, hkv, d), k_res=f(bsz, sk, RANK) * 0.3,
        v_res=f(bsz, sk, RANK) * 0.3, b_k=f(bsz, RANK, hkv * d) * 0.3,
        b_v=f(bsz, RANK, hkv * d) * 0.3, sin=tab(np.sin(ang)),
        cos=tab(np.cos(ang)),
        kv_len=None if sk == 1 else np.asarray([sk, sk - 13], np.int32))


def dense_ranges(kv_len, sk, window, n_split):
    """[lo, hi) of each CTA's range: the row's live keys [max(kv_len -
    window, 0), kv_len) in n_split equal ranges of whole multiples of
    SPLIT_KEYS * SPLIT_WARPS keys (``Range`` in residual_attention.cu)."""
    kvl = sk if kv_len is None else min(max(kv_len, 0), sk)
    first = max(kvl - window, 0) if window else 0
    keys = tra.SPLIT_KEYS * tra.SPLIT_WARPS
    per = -(-(-(-(kvl - first) // n_split)) // keys) * keys
    out = []
    for s in range(n_split):
        lo = min(kvl, first + s * per)
        out.append((lo, min(kvl, lo + per)))
    return out


def merge(parts):
    """(m, l, acc, acc_r) partials merged with weights 2^(m - max m) over
    those with l > 0; None when none saw a key."""
    seen = [pt for pt in parts if pt is not None and torch.all(pt[1] > 0)]
    if not seen:
        return None
    mx = torch.stack([pt[0] for pt in seen]).amax(0)
    w = [torch.exp2(pt[0] - mx)[:, None] for pt in seen]
    return (mx, sum(wi[:, 0] * pt[1] for wi, pt in zip(w, seen)),
            sum(wi * pt[2] for wi, pt in zip(w, seen)),
            sum(wi * pt[3] for wi, pt in zip(w, seen)))


def tile_layout(t):
    """The decode's inputs as its CTA holds them on chip: head rows in the
    tile's columns (``tra.tile_columns``; at head_dim 120 the halves at
    tile columns 0.. and 64.. of 128, the rest zero), sin/cos in the first
    d/2 of the tile's half.  The identity where the tile is the head's
    width."""
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


def emulate_dense(t, n_split, window, lowp=True):
    """#8's split-K decode, in its tile's layout (``tile_layout``; the
    output's real columns come back): per (row, kv head) and range, each of the
    CTA's warps runs an online softmax over its 16-key steps (warp w takes
    steps w, w + 4, ...; K = K_b + RoPE(K_r . B_k) in f32 from the caller's
    sin/cos, rounded once to bf16; P rounded to bf16 for P . V_b and P .
    V_r), the CTA merges its warps, the ranges are merged (in the kernel
    itself with one range, by the combine with several), and out = (acc +
    bf16(acc_r) . B_v) / max(l, 1e-20).  Returns the f32 output (B, Hq,
    D)."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if lowp else \
        (lambda x: x)
    scale, cols = t["q"].shape[-1] ** -0.5, tra.tile_columns(t["q"].shape[-1])
    t = tile_layout(t)
    q = t["q"]
    bsz, hq, d = q.shape
    sk, hkv = t["k_base"].shape[1], t["k_base"].shape[2]
    g = hq // hkv
    kl = torch.einsum("bsr,brn->bsn", t["k_res"].float(),
                      t["b_k"].float()).reshape(bsz, sk, hkv, d)
    sn, cs = t["sin"].float()[:, :, None], t["cos"].float()[:, :, None]
    x1, x2 = kl[..., :d // 2], kl[..., d // 2:]
    k = rnd(t["k_base"].float() + torch.cat([x1 * cs - x2 * sn,
                                             x2 * cs + x1 * sn], -1))
    v, vr = t["v_base"].float(), t["v_res"].float()
    b_v = t["b_v"].float().reshape(bsz, -1, hkv, d)
    c = scale * LOG2E
    step = tra.SPLIT_KEYS
    out = torch.zeros(bsz, hq, d)
    for b in range(bsz):
        kv = None if t["kv_len"] is None else int(t["kv_len"][b])
        for h in range(hkv):
            qh = q[b, h * g:(h + 1) * g].float()
            ctas = []
            for lo, hi in dense_ranges(kv, sk, window, n_split):
                warps = []
                for w in range(tra.SPLIT_WARPS):
                    starts = range(lo + w * step, hi, tra.SPLIT_WARPS * step)
                    if not starts:
                        warps.append(None)
                        continue
                    m = torch.full((g,), NEG_INIT)
                    l = torch.zeros(g)
                    acc, accr = torch.zeros(g, d), torch.zeros(g, RANK)
                    for k0 in starts:
                        sl = slice(k0, min(k0 + step, hi))
                        s = qh @ k[b, sl, h].T
                        m_new = torch.maximum(m, s.amax(-1) * c)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s * c - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + rnd(p) @ v[b, sl, h]
                        accr = accr * alpha[:, None] + rnd(p) @ vr[b, sl]
                        m = m_new
                    warps.append((m, l, acc, accr))
                ctas.append(merge(warps))
            row = merge(ctas)
            if row is None:
                continue                    # l = 0 everywhere: exactly 0
            _, lsum, acc, accr = row
            o = acc + rnd(accr) @ b_v[b, :, h]
            out[b, h * g:(h + 1) * g] = o / torch.clamp(lsum, min=1e-20)[
                :, None]
    return out[..., cols]


def dense_case(seed, d, g, sk, lowp):
    inp = dense_inputs(seed, d, g, sk)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in inp.items()}
    if lowp:
        t = {k: v.to(torch.bfloat16) if v is not None and
             v.is_floating_point() else v for k, v in t.items()}
    return inp, t


def dense_qpos(t):
    """(B, 1) position of each row's query: kv_len - 1 (Sk - 1 without
    kv_len)."""
    bsz, sk = t["q"].shape[0], t["k_base"].shape[1]
    kv = torch.full((bsz,), sk) if t["kv_len"] is None else \
        t["kv_len"].long()
    return (kv - 1)[:, None].to(torch.int32)


_DENSE = ("k_base", "v_base", "k_res", "v_res", "b_k", "b_v", "sin", "cos")


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("sk", DENSE_SK)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("d,g", DENSE_HEADS)
def test_dense_splitk_holds_half_the_bf16_gate(d, g, n_split, sk, window):
    """The rounding plan against the plain version on the same bf16
    inputs, evaluated in f32: the bf16 plain version rounds its own scores
    and probabilities to bf16 and sits up to ~0.7% of max |value| from its
    f32 evaluation at D 256 on rows of a few dozen keys, more than the
    0.5% that is to be held, so the f32 evaluation is the yardstick (the
    card holds the kernel to the bf16 plain version within 1%)."""
    _, t = dense_case(31, d, g, sk, lowp=True)

    f32 = {k: v.float() if v is not None and v.is_floating_point() else v
           for k, v in t.items()}
    want = tref.residual_attention_ref(
        f32["q"][:, None], *[f32[k] for k in _DENSE], qpos=dense_qpos(t),
        kv_len=t["kv_len"], window=window, scale=d ** -0.5)[:, 0]
    got = emulate_dense(t, n_split, window)
    err = (got - want).abs().max().item()
    assert err <= SHARE * want.abs().max().item()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("sk", DENSE_SK)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("d,g", DENSE_HEADS)
def test_dense_splitk_matches_jax_in_f32(d, g, n_split, sk, window):
    inp, t = dense_case(32, d, g, sk, lowp=False)
    got = emulate_dense(t, n_split, window, lowp=False).numpy()
    kv = inp["kv_len"]
    want = np.asarray(jref.residual_attention_ref(
        jnp.asarray(inp["q"])[:, None], *[jnp.asarray(inp[k]) for k in
                                          _DENSE],
        qpos=jnp.asarray(dense_qpos(t).numpy()),
        kv_len=None if kv is None else jnp.asarray(kv), window=window,
        scale=d ** -0.5))[:, 0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dense_ranges_cover_the_live_range_once():
    """#8's ranges tile each row's live keys exactly, in whole 64-key
    multiples, with the empty ones at the end; a row without keys has only
    empty ranges (and comes out exactly 0)."""
    keys = tra.SPLIT_KEYS * tra.SPLIT_WARPS
    for sk in (1, 45, 230, 4096):
        for kv_len in (None, 0, 1, 17, 45, 230, 4096):
            for window in (0, 77, 300):
                kvl = sk if kv_len is None else min(kv_len, sk)
                first = max(kvl - window, 0) if window else 0
                for n_split in (1, 2, 3, 7, 64):
                    got = dense_ranges(kv_len, sk, window, n_split)
                    assert [k for lo, hi in got for k in range(lo, hi)] == \
                        list(range(first, kvl))
                    full = [hi - lo for lo, hi in got if hi > lo][:-1]
                    assert all(n % keys == 0 for n in full)
    t = dense_case(33, 64, 4, 45, lowp=True)[1]
    t["kv_len"] = torch.tensor([0, 0], dtype=torch.int32)
    assert torch.all(emulate_dense(t, 3, 0) == 0.0)


@pytest.mark.parametrize("d,r,ctas", [
    (64, 16, 2), (64, 32, 2), (128, 16, 1), (128, 32, 1), (256, 16, 1),
    (256, 32, 1), (32, 16, 2), (32, 32, 2), (120, 16, 1), (120, 32, 1)])
def test_dense_split_smem_fits_the_card(d, r, ctas):
    """Each instance's shared memory fits a CTA of the H100 (227 KB; at D
    256 with one stage per warp), and as many CTAs per SM as the plan
    counts on fit together.  Head_dim 120 runs in D 128's tile and takes
    its memory."""
    smem = tra.decode_split_smem(d, r)
    assert smem <= 227 * 1024
    assert tra.decode_ctas_per_sm(d, r) == ctas
    assert ctas * (smem + tra.SMEM_PER_CTA_RESERVED) <= tra.SMEM_PER_SM


@pytest.mark.parametrize("bsz,hq,hkv,d,sk,window", [
    (4, 32, 8, 128, 1, 0),       # Llama3-8B's forward at S 1
    (4, 16, 1, 256, 1, 0),       # RecurrentGemma-9B's
    (4, 16, 1, 256, 1, 2048),
    (4, 8, 4, 32, 1, 0),         # tiny_serving_model(): D 32, G 2
    (4, 32, 8, 120, 1, 4096),    # h2o-danube-3-4b: D 120, window 4096
])
def test_dense_split_plan_one_range_skips_the_combine(bsz, hq, hkv, d, sk,
                                                      window):
    """At Sk 1 (the main path) one range covers every row: one CTA per
    (row, kv head, 16-head tile), no combine and no workspace."""
    plan = tra.decode_split_plan(bsz, hq, hkv, d, RANK, sk, window, 132)
    assert plan["n_split"] == 1
    assert plan["grid"] == (1, hkv * -(-(hq // hkv) // 16), bsz)
    assert plan["combine_grid"] == 0 and plan["workspace_bytes"] == 0


@pytest.mark.parametrize("bsz,hq,hkv,d,sk,window", [
    (4, 32, 8, 128, 4096, 0),    # Llama3-8B, a long cache
    (4, 16, 1, 256, 4096, 0),    # RecurrentGemma-9B
    (4, 16, 1, 256, 4096, 300),  # a window bounds the live keys
    (1, 8, 2, 64, 230, 0),
    (64, 32, 8, 128, 512, 0),    # more CTAs than the card holds
    (2, 128, 2, 128, 1000, 77),  # a group of 64: four head tiles
    (4, 8, 4, 32, 4096, 0),      # tiny_serving_model(): D 32, G 2
    (4, 32, 8, 120, 4096, 4096),  # h2o-danube-3-4b: workspace at D 120
])
def test_dense_split_plan_stays_in_bounds(bsz, hq, hkv, d, sk, window):
    plan = tra.decode_split_plan(bsz, hq, hkv, d, RANK, sk, window, 132)
    n, (grid_x, groups, rows) = plan["n_split"], plan["grid"]
    assert grid_x == n and rows == bsz
    assert groups == hkv * -(-(hq // hkv) // tra.SPLIT_HEADS)
    live = min(sk, window) if window else sk
    assert 1 <= n <= -(-live // (tra.SPLIT_KEYS * tra.SPLIT_WARPS))
    # one pass of the card's resident slots, unless one CTA per row and
    # head tile already exceeds it
    assert n == 1 or n * bsz * groups <= plan["ctas_per_sm"] * 132
    if n > 1:
        assert plan["combine_grid"] == bsz * hq
        assert plan["workspace_bytes"] == 4 * bsz * hq * n * (d + RANK + 2)
    else:
        assert plan["combine_grid"] == 0 == plan["workspace_bytes"]


def test_dense_split_plan_fills_the_card():
    """RecurrentGemma-9B at Sk 4096 (4 rows, one kv head) takes a range
    per SM; Llama3-8B (32 row-heads) 4 ranges each."""
    rg = tra.decode_split_plan(4, 16, 1, 256, RANK, 4096, 0, 132)
    assert rg["n_split"] * 4 >= 128
    ll = tra.decode_split_plan(4, 32, 8, 128, RANK, 4096, 0, 132)
    assert ll["n_split"] == 4


# ------------------------------------------------- the geometry checks
@pytest.mark.parametrize("d", [32, 64, 128, 120])
def test_paged_wrappers_take_head_dims_32_64_128(d):
    """Every paged kernel has an instance at head_dim 32 (the default
    tiny model's), 64 and 128, and runs 120 (h2o-danube-3-4b's) in D 128's
    tile, at groups up to 64 and any page size (above 32 as sub-pages)."""
    assert tpra.check_heads(8, 4, d, 16) == 2
    assert tpra.check_heads(64, 1, d, 32) == 64
    assert tpra.check_heads(32, 8, d, 64) == 4


@pytest.mark.parametrize("hq,hkv,d,page,what", [
    (8, 4, 48, 16, "head_dim 48"), (8, 4, 256, 16, "head_dim 256"),
    (32, 8, 96, 16, "head_dim 96"),
    (8, 4, 32, 0, "page size 0"), (8, 3, 32, 16, "multiple"),
    (128, 1, 32, 16, "group size")])
def test_paged_wrappers_refuse_other_geometry(hq, hkv, d, page, what):
    with pytest.raises(ValueError, match=what):
        tpra.check_heads(hq, hkv, d, page)


def test_dense_wrappers_take_head_dim_32_and_refuse_48():
    """The dense kernels take head_dims 32, 64, 120, 128 and 256; 48 is
    refused."""
    for d in (32, 64, 120, 128, 256):
        assert tra.tile_rows(d, 2) == tra.ROWS_BY_HEAD_DIM[d]
    with pytest.raises(ValueError, match="head_dim 48"):
        tra.tile_rows(48, 2)


# ------------------------------------------------- pages above MAX_PAGE
@pytest.mark.parametrize("page,sub", [(48, 24), (64, 32), (37, 1), (32, 32)])
def test_sub_page_is_the_largest_divisor_up_to_max_page(page, sub):
    assert tpra.sub_page(page) == sub


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("page", [48, 64])
def test_sub_pages_equal_the_original_pages(page, pages):
    """A page of ``page`` > MAX_PAGE tokens served as ``sub_page(page)``-
    token pages: the pools (and int8 scale pools) are views of the same
    memory, the tables expanded, and the plain versions of the decode, the
    chunked prefill and the mixed grid, disaggregated and base-only, give
    the same output bit for bit on the views as on the original pools."""
    rng = np.random.default_rng(page)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    bsz, width = 3, 4
    pool = bsz * width + 2
    t = dict(kb=f(pool, page, HKV, D), vb=f(pool, page, HKV, D),
             kr=f(pool, page, RANK) * 0.3, vr=f(pool, page, RANK) * 0.3,
             b_k=f(bsz, RANK, HKV * D) * 0.3, b_v=f(bsz, RANK, HKV * D) * 0.3)
    for name in ("bt_b", "bt_r"):
        t[name] = torch.from_numpy(rng.permutation(pool)[:bsz * width]
                                   .reshape(bsz, width).astype(np.int32))
    ks = vs = None
    if pages == "int8":
        (t["kb"], ks), (t["vb"], vs) = quantize_kv(t["kb"]), \
            quantize_kv(t["vb"])
    kb, vb, ks2, vs2, kr, vr, bt_b, bt_r = tpra.sub_pages(
        t["kb"], t["vb"], ks, vs, t["kr"], t["vr"], t["bt_b"], t["bt_r"])
    s = tpra.sub_page(page)
    assert kb.shape[1] == s and kb.data_ptr() == t["kb"].data_ptr()
    assert bt_b.shape == (bsz, width * page // s)
    assert torch.equal(bt_b[:, :page // s],
                       t["bt_b"][:, :1] * (page // s) +
                       torch.arange(page // s, dtype=torch.int32))
    start = torch.tensor([0, 70, page * width - 20], dtype=torch.int32)
    q_len = torch.tensor([page + 5, 33, 20], dtype=torch.int32)
    kv_len = start + q_len
    q = f(bsz, int(q_len.max()), HQ, D)
    kw = dict(window=0, kb_scale=ks, vb_scale=vs)
    kw2 = dict(window=0, kb_scale=ks2, vb_scale=vs2)
    for res in (True, False):
        ra = [t["kr"], t["vr"], t["b_k"], t["b_v"]] if res else [None] * 4
        rb = [kr, vr, t["b_k"], t["b_v"]] if res else [None] * 4
        tr, tr2 = (t["bt_r"], bt_r) if res else (None, None)
        pairs = [
            (tref.paged_residual_attention_ref(
                q[:, 0], t["kb"], t["vb"], *ra, t["bt_b"], tr, kv_len, **kw),
             tref.paged_residual_attention_ref(
                 q[:, 0], kb, vb, *rb, bt_b, tr2, kv_len, **kw2)),
            (tref.paged_residual_attention_prefill_ref(
                q, t["kb"], t["vb"], *ra, t["bt_b"], tr, start, kv_len,
                **kw),
             tref.paged_residual_attention_prefill_ref(
                 q, kb, vb, *rb, bt_b, tr2, start, kv_len, **kw2)),
            (tref.paged_residual_attention_mixed_ref(
                q, t["kb"], t["vb"], *ra, t["bt_b"], tr, start, q_len,
                kv_len, **kw),
             tref.paged_residual_attention_mixed_ref(
                 q, kb, vb, *rb, bt_b, tr2, start, q_len, kv_len, **kw2))]
        for want, got in pairs:
            assert torch.equal(got, want)


# ------------------------------------------------------- LoRA rank 64
SMEM_PER_CTA = 227 * 1024
RANKS = (1, 5, 16, 17, 32, 33, 48, 64)


def res_mma_smem(d, r, int8):
    """Shared-memory bytes of one CTA of #5's tensor-core tile, which #1
    shares (``PagedResMmaLayout`` in ``paged_residual_disagg.cu``): Q
    (``MMA_ROWS`` rows), B_k and B_v (RP rows each), two stages of a
    64-key block's K/V tile (int8 pages share one converted tile and stage
    codes and scales apart), K_r, V_r, sin and cos; rows padded by 8
    elements, at the tile's width."""
    d, rp = tra.tile_dim(d), tra.rank_instance(r)
    ds, rs, hs, bk = d + 8, rp + 8, d // 2 + 8, 64
    tile = 2 * bk * ds
    stage = (0 if int8 else tile) + 2 * bk * rs + 2 * bk * hs
    elems = tpra.MMA_ROWS * ds + 2 * rp * ds + (tile if int8 else 0) + \
        2 * stage
    return 2 * elems + (2 * (2 * bk * d + 2 * bk * 4) if int8 else 0)


def template_smem(rows, d, r, page):
    """Bytes of one CTA of the f32 template with the residual stream
    (``Layout`` of ``paged_template.cuh``, f32 words): Q, acc, scores and
    softmax state of ``rows`` rows, a page of K and V, the inverse
    frequencies, acc_r, a page of K_r and V_r, B_k and B_v."""
    return 4 * (rows * (d + 1) + rows * d + rows * (page + 1) + 3 * rows +
                page * (d + 1) + page * d + d // 2 + rows * r +
                2 * page * r + 2 * r * d)


def mma_smem(d, r):
    """Bytes of one CTA of #7's tensor-core tile (``MmaLayout`` in
    ``residual_attention.cu``): the rows' positions, Q (``mma_rows``
    rows), B_k and B_v (RP rows each) and two stages of a key block (64
    keys; 32 at D 256) of K, V, K_r, V_r, sin and cos, bf16."""
    rows, td, rp = tra.mma_rows(d, r), tra.tile_dim(d), tra.rank_instance(r)
    bk = 32 if td == 256 else 64
    ds, rs, hs = td + 8, rp + 8, td // 2 + 8
    return 4 * rows + 2 * (rows * ds + 2 * rp * ds +
                           2 * bk * (2 * ds + 2 * rs + 2 * hs))


@pytest.mark.parametrize("fn,args,nbytes", [
    (res_mma_smem, (128, 64, False), 212992),
    (res_mma_smem, (128, 64, True), 211968),
    (template_smem, (64, 128, 64, 32), 206464),
    (mma_smem, (256, 64), 222464),
    (mma_smem, (256, 32), 214528)])
def test_layout_bytes_at_rank_64(fn, args, nbytes):
    """The layouts' bytes at the largest instances, as the sources' layout
    structs add them up (fixed here so a change to either side shows)."""
    assert fn(*args) == nbytes


@pytest.mark.parametrize("r,rp", [(1, 16), (16, 16), (17, 32), (32, 32),
                                  (33, 64), (48, 64), (64, 64)])
def test_rank_instance_is_the_smallest_that_holds_the_rank(r, rp):
    assert tra.rank_instance(r) == rp
    assert not tra.rank_chunked(r)
    assert tra.RANK_CHUNK == 64 and tra.RANK_INSTANCES[-1] == 64


@pytest.mark.parametrize("r", [0, 65, 128, 256])
def test_ranks_outside_1_to_64_are_refused_by_name(r):
    """Ranks above 64 are taken (the chunked instances: chunks of 64 in
    the bf16 kernels, of ``SCALAR_RANK_CHUNK`` in the f32 scalar kernels,
    every launch counted under ``<counter>_rchunk``); a rank below 1 is
    refused, naming it."""
    if r < 1:
        with pytest.raises(ValueError, match=f"rank {r} not in"):
            tra.rank_instance(r)
        return
    assert tra.rank_instance(r) == tra.RANK_CHUNK and tra.rank_chunked(r)
    for d in (32, 64, 120, 128, 256):
        assert tra.scalar_chunked(d, 4, r)
        rows = tra.scalar_rows(d, 4, r)
        assert tra.scalar_smem(rows, rows // 4, d, r, chunk=True) <= \
            SMEM_PER_CTA
        assert tra.mma_rows(d, r) == tra.MMA_ROWS
        assert tra.decode_split_smem(d, r) <= SMEM_PER_CTA
    for d, int8 in itertools.product((32, 64, 120, 128), (False, True)):
        assert tpra.res_split_smem(d, r, int8) <= SMEM_PER_CTA
    assert tpra.kernel_name("paged_residual_attention_mixed",
                            torch.bfloat16, True, r) == \
        "paged_residual_attention_mixed_int8_mma_rchunk"
    assert tra.decode_kernel(torch.bfloat16, r) == \
        "residual_attention_decode_splitk_rchunk"


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_paged_rank_plans_fit_the_card(d):
    """#5/#1's tile, #2's split-K decode and the f32 template (rows of 64
    at the largest page) fit a CTA at every rank up to 64, bf16 and int8
    pages; #2's plan counts on no more resident CTAs than fit an SM."""
    for r, int8 in itertools.product(RANKS, (False, True)):
        assert res_mma_smem(d, r, int8) <= SMEM_PER_CTA
        smem = tpra.res_split_smem(d, r, int8)
        assert smem + 2048 <= SMEM_PER_CTA
        ctas = tpra.res_ctas_per_sm(d, r, int8)
        assert ctas * (smem + tpra.SMEM_PER_CTA_RESERVED) <= tpra.SMEM_PER_SM
        assert template_smem(tpra.MAX_ROWS, d, r, tpra.MAX_PAGE) <= \
            SMEM_PER_CTA


@pytest.mark.parametrize("d", [32, 64, 120, 128, 256])
def test_dense_rank_plans_fit_the_card(d):
    """#7's tensor-core prefill (128 query rows, 64 at D 256 above rank
    32), #8's split-K decode and the scalar kernel (its rows for every
    group up to 16, and up to 32 at D <= 128) fit a CTA at every rank up
    to 64."""
    for r in RANKS:
        assert mma_smem(d, r) <= SMEM_PER_CTA
        assert tra.decode_split_smem(d, r) <= SMEM_PER_CTA
        for g in (1, 2, 4, 8, 16, 32):
            if g > (16 if d == 256 else 32):
                continue
            rows = tra.tile_rows(d, g, r)
            tq = rows // g
            assert tra.scalar_smem(tq * g, tq, d, r) <= SMEM_PER_CTA
    assert tra.mma_rows(d, 64) == (64 if d == 256 else 128)
    assert tra.mma_rows(d, 32) == 128


@pytest.mark.parametrize("r,rows", [(16, 32), (26, 32), (32, 32), (33, 32),
                                    (48, 16), (64, 16)])
def test_scalar_kernel_takes_every_rank_at_head_dim_256(r, rows):
    """RecurrentGemma-9B's heads (G 16, D 256) in f32: 32 query rows a CTA
    up to rank 33 (B_v now loads over the key block after the key loop,
    which ends the old limit of ~26), 16 above; no rank up to 64 is
    refused, and a tile holds one whole group."""
    assert tra.tile_rows(256, 16, r) == rows
    assert tra.tile_positions(256, 16, 300, torch.float32, r) == rows // 16


def test_scalar_kernel_refuses_a_group_of_32_at_head_dim_256_rank_64():
    """A tile holds whole groups: 32 heads of 256 columns at rank 64 need
    ~253 KB in the unchunked layout, more than a CTA has, so that group
    runs the chunked instance, which holds them in 32 rows (it was refused
    before); at rank 32 the same group takes 32 rows unchunked.  A group
    no tile holds (64 heads at D 256) is still refused by name."""
    assert tra.scalar_smem(32, 1, 256, 64) > SMEM_PER_CTA
    assert tra.scalar_chunked(256, 32, 64)
    assert tra.tile_rows(256, 32, 64) == 32
    assert tra.scalar_smem(32, 1, 256, 64, chunk=True) <= SMEM_PER_CTA
    assert tra.prefill_kernel(torch.float32, 64, 256, 32) == \
        "residual_attention_prefill_rchunk"
    assert not tra.scalar_chunked(256, 32, 32)
    assert tra.tile_rows(256, 32, 32) == 32
    with pytest.raises(ValueError, match="group size 64 > 32"):
        tra.tile_rows(256, 64, 64)


@pytest.mark.parametrize("d,r,tq", [(128, 64, 32), (256, 64, 16),
                                    (256, 32, 32), (120, 48, 32)])
def test_mma_tile_positions_follow_its_rows(d, r, tq):
    assert tra.tile_positions(d, 4, 1000, torch.bfloat16, r) == tq


# ---------------------------------------------- no silent gradient
def _guard_calls():
    """Each of the eight attention wrappers (#1-#8) on tiny CPU tensors
    whose q requires grad, with the kernel's name."""
    q4 = torch.zeros(1, 2, 2, 32, requires_grad=True)
    q3 = torch.zeros(1, 2, 32, requires_grad=True)
    kb = torch.zeros(2, 16, 1, 32)
    kr = torch.zeros(2, 16, 4)
    bk = torch.zeros(1, 4, 32)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    ck = torch.zeros(1, 8, 1, 32)
    cr = torch.zeros(1, 8, 4)
    sc = torch.zeros(1, 8, 16)
    qpos = torch.zeros(1, 2, dtype=torch.int32)
    kw = dict(scale=0.1)
    return [
        ("paged_residual_attention_mixed", lambda q=q4: tpra.
         paged_residual_attention_mixed(q, kb, kb, kr, kr, bk, bk, bt, bt,
                                        one, one, one, **kw)),
        ("paged_residual_attention_decode", lambda q=q3: tpra.
         paged_residual_attention_decode(q, kb, kb, kr, kr, bk, bk, bt, bt,
                                         one, **kw)),
        ("paged_residual_attention_prefill", lambda q=q4: tpra.
         paged_residual_attention_prefill(q, kb, kb, kr, kr, bk, bk, bt, bt,
                                          one, one, **kw)),
        ("paged_attention_mixed_base", lambda q=q4: tpra.
         paged_attention_mixed_base(q, kb, kb, bt, one, one, one, **kw)),
        ("paged_attention_decode_base", lambda q=q3: tpra.
         paged_attention_decode_base(q, kb, kb, bt, one, **kw)),
        ("paged_attention_prefill_base", lambda q=q4: tpra.
         paged_attention_prefill_base(q, kb, kb, bt, one, one, **kw)),
        ("residual_attention_prefill", lambda q=q4: tra.
         residual_attention_prefill(q, ck, ck, cr, cr, bk, bk, sc, sc, qpos,
                                    **kw)),
        ("residual_attention_decode", lambda q=q3: tra.
         residual_attention_decode(q, ck, ck, cr, cr, bk, bk, sc, sc,
                                   **kw)),
    ]


@pytest.mark.parametrize("i", range(8))
def test_attention_wrappers_refuse_an_input_that_requires_grad(i):
    """The kernels have no backward (nor have the Pallas kernels they
    replace): with grad mode on, an input that requires grad is refused
    with a RuntimeError naming the kernel, before any device check; under
    ``torch.no_grad`` the call gets past the guard to the wrapper's own
    checks (which refuse these CPU tensors: the kernels take CUDA
    tensors)."""
    name, call = _guard_calls()[i]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        call()
