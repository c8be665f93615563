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
shares empty); windows 0 and 77, which straddles shares.  Also
``decode_splits`` and ``split_heads``, the wrapper's launch plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import paged_residual_attention as tpra
from repro_torch.kernels import ref as tref
from repro_torch.models.transformer import quantize_kv

LOG2E = 1.4426950408889634
NEG_INIT = -1e30
SHARE = 0.005        # half of chip_smoke's BF16_RTOL
HQ, HKV, D, PAGE = 8, 2, 64, 16
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


def inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bsz = len(KV_LEN)
    pool = bsz * WIDTH + 3
    bt = rng.permutation(pool)[:bsz * WIDTH].reshape(bsz, WIDTH)
    return dict(q=f(bsz, HQ, D), kb=f(pool, PAGE, HKV, D),
                vb=f(pool, PAGE, HKV, D), bt_b=bt.astype(np.int32),
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

    k, v = gather(t["kb"], ks), gather(t["vb"], vs)
    qs = q.float() * (d ** -0.5 * LOG2E)
    out = torch.zeros(bsz, hq, d)
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
    return out


def seen_rows():
    return torch.tensor(KV_LEN) > 0


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_splitk_holds_half_the_bf16_gate(pages, n_split, window):
    t = {k: torch.from_numpy(v) for k, v in inputs(seed=21).items()}
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
@pytest.mark.parametrize("pages", ["f32", "int8"])
def test_splitk_matches_jax_in_f32(pages, n_split, window):
    t = {k: torch.from_numpy(v) for k, v in inputs(seed=22).items()}
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
