#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ForkKV on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  Phases, each of which fails the run (non-zero exit) on any
error:

1. environment: the card's name and power limit, torch/CUDA versions;
   TF32 is switched off for matmul and cuDNN so f32 runs are IEEE f32;
2. build: nvcc compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a;
3. kernels: the four paged attention kernels (mixed and decode,
   disaggregated and base-only) at Llama3-8B's head geometry, in f32 and
   bf16, against their plain PyTorch versions on the same inputs, with
   times, the card's bound for the same work, and for the base-only
   kernels ``scaled_dot_product_attention`` as a yardstick;
4. a small f32 model served on the card and on the CPU: identical greedy
   tokens in forkkv and prefix mode;
5. Llama3-8B at full width and depth (random bf16 weights from seed 0)
   serving one 2048-token session with 8 staggered forks over 4 LoRA
   adapters in forkkv mode, then 6. the same in prefix mode; the launch
   counters show each path went through its kernels and never through a
   plain version, and every launch's geometry is recorded;
7. the kernels again, at every launch geometry the serve of 5./6. gave
   them (batch, query width, table width, per-row start and q_len), in
   f32 and bf16 against their plain versions; the heaviest one, in bf16,
   is timed and its numbers make the kernels line;
8. the kernels line, the card line and the result line.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_TOL = 1e-4        # f32 kernel vs plain version (summation order only)
BF16_RTOL = 1e-2      # bf16, as a share of the plain version's max |value|:
                      # the output's own rounding is one ulp, 2^-8 of a
                      # value, and the plain version rounds K/V and sin/cos
                      # to bf16 where the kernel rebuilds K in f32
PLAIN_SCORE_BYTES = 2 << 30   # f32 score block of one plain-version call
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}   # H100 SXM, dense
HBM_BW = 3.35e12
LLAMA_GEOM = dict(hq=32, hkv=8, d=128, r=16, page=16)


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
_FLUSH = None


def time_ms(fn, reps=10, warmup=2):
    """Mean device time of one call, L2 flushed before each call (the
    serving path finds each layer's pages cold).  A short device sleep
    ahead of the start event keeps the card busy while the host enqueues
    the call, so the host's own time is not counted."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ------------------------------------------------------- kernel inputs
_KVL = [2048, 1500, 1023, 777, 512, 300, 129, 64]
FIXED = {
    # 8 decode rows, ragged kv_len up to 2048
    "decode": dict(start=[k - 1 for k in _KVL], qlen=[1] * 8, sq=1,
                   width=128),
    # one 512-token prefill row starting mid-page at 1000, 7 decode rows,
    # one q_len=0 row
    "mixed": dict(start=[1000] + [k - 1 for k in _KVL[:7]] + [0],
                  qlen=[512] + [1] * 7 + [0], sq=512, width=128),
}


def make_case(kind, dtype, window, seed, start, qlen, sq, width,
              device="cuda"):
    """Random inputs at Llama3-8B's head geometry for rows that start at
    ``start`` with ``qlen`` query positions each (decode: qlen 1, sq 1),
    padded to ``sq`` positions, over block tables ``width`` pages wide
    drawn from a shuffled pool."""
    g = LLAMA_GEOM
    bsz = len(start)
    pool = bsz * width + 16
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dtype)

    perm = lambda: torch.randperm(pool, generator=gen,  # noqa: E731
                                  device=device)[:bsz * width]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=device)
    c = dict(
        kb=rn(pool, g["page"], g["hkv"], g["d"]),
        vb=rn(pool, g["page"], g["hkv"], g["d"]),
        kr=rn(pool, g["page"], g["r"], scale=0.3),
        vr=rn(pool, g["page"], g["r"], scale=0.3),
        b_k=rn(bsz, g["r"], g["hkv"] * g["d"], scale=0.3),
        b_v=rn(bsz, g["r"], g["hkv"] * g["d"], scale=0.3),
        bt_b=perm().reshape(bsz, width).to(torch.int32).contiguous(),
        bt_r=perm().reshape(bsz, width).to(torch.int32).contiguous(),
        start=i32(start), q_len=i32(qlen),
        kv_len=i32([s + n for s, n in zip(start, qlen)]))
    c["q"] = rn(bsz, g["hq"], g["d"]) if kind == "decode" else \
        rn(bsz, sq, g["hq"], g["d"])
    c.update(kind=kind, window=window, scale=g["d"] ** -0.5, dtype=dtype,
             start_l=start, qlen_l=qlen)
    return c


def kernel_call(pra, name, c):
    """The kernel wrapper ``name`` on case ``c``."""
    kw = dict(scale=c["scale"], window=c["window"])
    if name == "paged_residual_attention_mixed":
        return lambda: pra.paged_residual_attention_mixed(
            c["q"], c["kb"], c["vb"], c["kr"], c["vr"], c["b_k"], c["b_v"],
            c["bt_b"], c["bt_r"], c["start"], c["q_len"], c["kv_len"], **kw)
    if name == "paged_residual_attention_decode":
        return lambda: pra.paged_residual_attention_decode(
            c["q"], c["kb"], c["vb"], c["kr"], c["vr"], c["b_k"], c["b_v"],
            c["bt_b"], c["bt_r"], c["kv_len"], **kw)
    if name == "paged_attention_mixed_base":
        return lambda: pra.paged_attention_mixed_base(
            c["q"], c["kb"], c["vb"], c["bt_b"], c["start"], c["q_len"],
            c["kv_len"], **kw)
    return lambda: pra.paged_attention_decode_base(
        c["q"], c["kb"], c["vb"], c["bt_b"], c["kv_len"], **kw)


def plain_call(ref, name, c):
    """The plain version on case ``c``.  It holds several f32 tensors of
    (rows, Hq, Sq, Sk), so a case above ``PLAIN_SCORE_BYTES`` of scores runs
    as one call per slice of batch rows (rows are independent)."""
    res = "residual" in name
    kw = dict(scale=c["scale"], window=c["window"])
    bsz = c["bt_b"].shape[0]
    sq = c["q"].shape[1] if c["kind"] == "mixed" else 1
    sk = c["bt_b"].shape[1] * LLAMA_GEOM["page"]
    step = max(1, PLAIN_SCORE_BYTES // (LLAMA_GEOM["hq"] * sq * sk * 4))

    def rows(sl):
        args = [c["q"][sl], c["kb"], c["vb"]] + (
            [c["kr"], c["vr"], c["b_k"][sl], c["b_v"][sl]] if res
            else [None] * 4) + [c["bt_b"][sl], c["bt_r"][sl] if res else None]
        if c["kind"] == "mixed":
            return ref.paged_residual_attention_mixed_ref(
                *args, c["start"][sl], c["q_len"][sl], c["kv_len"][sl], **kw)
        return ref.paged_residual_attention_ref(*args, c["kv_len"][sl], **kw)

    if step >= bsz:
        return lambda: rows(slice(0, bsz))
    return lambda: torch.cat([rows(slice(lo, lo + step))
                              for lo in range(0, bsz, step)])


def library_call(c):
    """``scaled_dot_product_attention`` over the same base K/V laid out
    contiguously, GQA heads expanded and the paged masks as a boolean
    mask: a yardstick for the base-only kernels, never used by the port."""
    g = LLAMA_GEOM
    bsz, width, page = c["bt_b"].shape[0], c["bt_b"].shape[1], g["page"]
    sk = width * page
    rep = g["hq"] // g["hkv"]
    bt = c["bt_b"].long()

    def lay(pool):
        x = pool[bt].reshape(bsz, sk, g["hkv"], g["d"]).transpose(1, 2)
        return x.repeat_interleave(rep, dim=1).contiguous()

    k, v = lay(c["kb"]), lay(c["vb"])
    q = c["q"][:, :, None] if c["kind"] == "decode" else c["q"]
    q = q.transpose(1, 2).contiguous() if c["kind"] == "mixed" else \
        q.contiguous()
    sq = q.shape[2]
    dev = c["q"].device
    qpos = c["start"][:, None] + torch.arange(sq, device=dev)[None]
    kpos = torch.arange(sk, device=dev)
    mask = (kpos[None, None] <= qpos[..., None]) & \
        (kpos[None, None] < c["kv_len"][:, None, None])
    if c["window"]:
        mask &= kpos[None, None] > qpos[..., None] - c["window"]
    mask = mask[:, None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, scale=c["scale"])


def work(name, c):
    """Bytes the function must move and operations it must do on these
    inputs: live pages of each row (the kernel's page-loop bounds), the q
    rows below q_len and B_k/B_v read once, all of out (padding rows are
    zeroed) written once; one QK and one PV product per unmasked
    (query, key) pair and head, plus the rank-R reconstruction."""
    g = LLAMA_GEOM
    res = "residual" in name
    esize = torch.tensor([], dtype=c["dtype"]).element_size()
    page, d, hq, hkv, r = g["page"], g["d"], g["hq"], g["hkv"], g["r"]
    w = c["window"]
    pages, pairs, live_tokens, rows = set(), 0, 0, 0
    for b, (st, ql) in enumerate(zip(c["start_l"], c["qlen_l"])):
        if ql == 0:
            continue
        kvl = st + ql
        lo = max(st - (w - 1), 0) // page if w else 0
        hi = (kvl - 1) // page
        for j in range(lo, hi + 1):
            pages.add((b, j))
        live_tokens += (hi - lo + 1) * page
        rows += ql
        for qp in range(st, st + ql):
            first = max(0, qp - w + 1) if w else 0
            pairs += qp - first + 1
    nbytes = len(pages) * page * hkv * d * esize * 2
    nbytes += rows * hq * d * esize                         # live q rows
    nbytes += c["q"].numel() * esize                        # all of out
    ops = pairs * hq * 4 * d
    if res:
        nbytes += len(pages) * page * r * esize * 2
        nbytes += 2 * c["b_k"].numel() * esize
        ops += live_tokens * hkv * 2 * r * d                # K_r . B_k
        ops += pairs * hq * 2 * r                           # P . V_r
        ops += rows * hq * 2 * r * d                        # acc_r . B_v
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / PEAK[c["dtype"]] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


KERNELS = {
    # name: (case kind, replaces)
    "paged_residual_attention_mixed": (
        "mixed", "src/repro/kernels/paged_residual_attention.py:764"),
    "paged_residual_attention_decode": (
        "decode", "src/repro/kernels/paged_residual_attention.py:206"),
    "paged_attention_mixed_base": (
        "mixed", "src/repro/kernels/paged_residual_attention.py:910"),
    "paged_attention_decode_base": (
        "decode", "src/repro/kernels/paged_residual_attention.py:345"),
}
TODO = [
    ("paged_residual_attention_prefill",
     "src/repro/kernels/paged_residual_attention.py:488"),
    ("paged_attention_prefill_base",
     "src/repro/kernels/paged_residual_attention.py:633"),
    ("residual_attention_prefill",
     "src/repro/kernels/residual_attention.py:111"),
    ("residual_attention_decode",
     "src/repro/kernels/residual_attention.py:267"),
    ("rg_lru_scan", "src/repro/kernels/rg_lru.py:48"),
]


DTYPES = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_RTOL))


def compare(pra, ref, name, c, tol, case):
    """The kernel against its plain version on ``c``; raises on a
    non-zero q_len=0 row or an error past ``tol`` (f32: absolute; bf16: a
    share of the plain version's max |value|).  Returns the record to log."""
    got = kernel_call(pra, name, c)()
    want = plain_call(ref, name, c)()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if c["kind"] == "mixed":
        pad = [b for b, ql in enumerate(c["qlen_l"]) if ql == 0]
        if pad and got[pad].abs().max().item() != 0.0:
            raise AssertionError(f"{name} {case}: q_len=0 row not 0")
    ref_max = want.float().abs().max().item()
    limit = tol * ref_max if c["dtype"] == torch.bfloat16 else tol
    rec = dict(kernel=name, dtype=str(c["dtype"]).split(".")[1], case=case,
               window=c["window"], max_abs_err=err, ref_max_abs=ref_max,
               limit=limit)
    del got, want
    if err > limit:
        log("kernel", **rec, ok=False)
        raise AssertionError(f"{name} {case} {c['dtype']} window="
                             f"{c['window']}: max abs err {err} > {limit}")
    return rec


def measure(pra, ref, name, c, rec):
    """Adds the kernel's, the plain version's and (base-only kernels) the
    library call's times and the bound on ``c`` to ``rec``."""
    rec["kernel_ms"] = time_ms(kernel_call(pra, name, c))
    rec["plain_ms"] = time_ms(plain_call(ref, name, c), reps=3, warmup=1)
    rec["library_ms"] = None if "residual" in name else \
        time_ms(library_call(c))
    (rec["bound_ms"], rec["bound_by"], rec["bytes"],
     rec["ops"]) = work(name, c)
    return rec


def check_kernels(pra, ref):
    """Phase 3: every kernel against its plain version, f32 and bf16, at
    the fixed cases, without and with a sliding window, each timed."""
    for dtype, tol in DTYPES:
        for window in (0, 300):
            cases = {k: make_case(k, dtype, window, seed=1 + window,
                                  **FIXED[k]) for k in FIXED}
            for name, (kind, _) in KERNELS.items():
                c = cases[kind]
                rec = compare(pra, ref, name, c, tol, kind)
                log("kernel", **measure(pra, ref, name, c, rec), ok=True)
            del cases
            torch.cuda.empty_cache()


def check_serving_shapes(pra, ref, recorded):
    """Phase 7: each kernel at every distinct launch geometry of the
    serve, f32 and bf16, on random inputs.  Of launches with the same
    (batch, query width, table width, window) the one with the most
    (query, key) pairs stands for them.  The heaviest overall is timed in
    bf16, what the server runs; returns those records per kernel."""
    results = {}
    for name, launches in recorded.items():
        kind = "decode" if "decode" in name else "mixed"
        best = {}
        for launch in launches:
            bsz, sq, width, window, start, qlen = launch
            pairs = sum((s + n) * n for s, n in zip(start, qlen))
            if launch[:4] not in best or pairs > best[launch[:4]][0]:
                best[launch[:4]] = (pairs, launch)
        heaviest = max(best.values())[1]
        for _, launch in best.values():
            bsz, sq, width, window, start, qlen = launch
            case = f"serve B={bsz} Sq={sq} W={width}"
            for dtype, tol in DTYPES:
                c = make_case(kind, dtype, window, seed=5, start=list(start),
                              qlen=list(qlen), sq=sq, width=width)
                rec = compare(pra, ref, name, c, tol, case)
                rec.update(start=list(start), q_len=list(qlen))
                if launch is heaviest and dtype == torch.bfloat16:
                    results[name] = measure(pra, ref, name, c, rec)
                log("kernel", **rec, ok=True)
                del c
                torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- serving
def serve(server, vocab, ctx_len, n_forks, n_adapters, instr_len, max_new,
          seed, sampling_cls):
    """One pinned session of ``ctx_len`` tokens and ``n_forks`` greedy
    forks over ``n_adapters`` adapters, the second half submitted after the
    first half has started decoding, so plans mix decode and prefill rows.
    Returns (outputs, metrics, seconds)."""
    rng = np.random.default_rng(seed)
    ctx = [int(t) for t in rng.integers(0, vocab, ctx_len)]
    instrs = [[int(t) for t in rng.integers(0, vocab, instr_len)]
              for _ in range(n_forks)]
    sp = sampling_cls(max_new_tokens=max_new)
    t0 = time.perf_counter()
    with server.session(ctx, adapter_id=0) as sess:
        half = n_forks // 2
        handles = [sess.fork(i % n_adapters, instrs[i], sp)
                   for i in range(half)]
        eng = server.engine
        while eng.waiting or eng.running:       # until one fork decodes
            if any(r.state == "decode" for r in eng.running):
                break
            server.poll()
        handles += [sess.fork(i % n_adapters, instrs[i], sp)
                    for i in range(half, n_forks)]
        outs = server.wait(handles)
    if eng.executor.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = server.metrics()
    eng._evict(eng.base_pool, eng.base_pool.num_pages)
    if eng.mode == "forkkv":
        eng._evict(eng.res_pool, eng.res_pool.num_pages)
    m["drained_free_base"] = eng.base_pool.free_pages
    m["drained_free_res"] = eng.res_pool.free_pages
    m["total_base"] = eng.base_pool.num_pages
    m["total_res"] = eng.res_pool.num_pages
    return outs, m, seconds


def check_serving(outs, m, max_new):
    for o in outs:
        if o.finish_reason != "length" or len(o.tokens) != max_new:
            raise AssertionError(f"request {o.rid}: {o.finish_reason} "
                                 f"{len(o.tokens)} tokens {o.error}")
    for key in ("exec_errors", "quarantined", "fallback_gather_calls"):
        if m[key] != 0:
            raise AssertionError(f"{key} = {m[key]}")
    if m["mixed_steps"] < 1:
        raise AssertionError("no mixed plan ran")
    if m["drained_free_base"] != m["total_base"] - 1 or \
            m["drained_free_res"] != m["total_res"] - 1:
        raise AssertionError("pages leaked after close + evict")


def check_counts(pra, ref, expect_kernels):
    ran = {k: v for k, v in pra.LAUNCHES.items() if k in expect_kernels}
    if not all(v > 0 for v in ran.values()):
        raise AssertionError(f"kernels not launched: {ran}")
    if any(ref.LAUNCHES.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{ref.LAUNCHES}")
    return ran


class LaunchShapes:
    """Records the geometry of every launch of the kernel wrappers while
    it is entered: batch, query width, table width, window, and each
    row's start and q_len (kept as device copies and read afterwards, so
    recording adds no host sync).  It wraps the module's functions and
    calls through, so the launch counters are untouched."""

    def __init__(self, pra):
        self.pra, self.raw, self.orig = pra, [], {}

    def __enter__(self):
        for name in KERNELS:
            self.orig[name] = getattr(self.pra, name)
            setattr(self.pra, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.pra, name, fn)

    def _wrap(self, name, fn):
        res, decode = "residual" in name, "decode" in name

        def call(*args, **kw):
            q, bt = args[0], args[7 if res else 3]
            i = 9 if res else 4                  # kv_len, or start, q_len
            rows = (args[i].clone(),) if decode else \
                (args[i].clone(), args[i + 1].clone())
            self.raw.append((name, q.shape[0], 1 if decode else q.shape[1],
                             bt.shape[1], kw.get("window", 0), rows))
            return fn(*args, **kw)
        return call

    def launches(self):
        """{kernel: [(bsz, sq, width, window, start, qlen), ...]},
        distinct launches in order."""
        out = {}
        for name, bsz, sq, width, window, rows in self.raw:
            if len(rows) == 1:
                kv = rows[0].tolist()
                start, qlen = tuple(k - 1 for k in kv), (1,) * len(kv)
            else:
                start, qlen = tuple(rows[0].tolist()), tuple(rows[1].tolist())
            key = (bsz, sq, width, window, start, qlen)
            if key not in out.setdefault(name, []):
                out[name].append(key)
        return out


def reset_counts(*mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def small_model_card_vs_cpu(tiny, tfm, ForkServer, ServeConfig,
                            SamplingParams):
    """Phase 4: a 2-layer f32 model (head_dim 64) served on the card and
    on the CPU from the same weights must give the same greedy tokens."""
    cfg = tiny(rank=16, num_layers=2, d_model=256, num_heads=4,
               num_kv_heads=2, vocab_size=512)
    params = tfm.init_params(cfg, 0, device="cpu")
    lora = tfm.init_lora_stacks(cfg, 1, 4, device="cpu")
    to_cuda = lambda t: {k: to_cuda(v) if isinstance(v, dict)  # noqa
                         else v.cuda() for k, v in t.items()}
    for mode in ("forkkv", "prefix"):
        sc = ServeConfig(page_size=16, max_pages=128, max_batch=8,
                         max_prefill_tokens=64, max_pages_per_req=16,
                         mode=mode)
        toks = {}
        for dev in ("cuda", "cpu"):
            p, lo = (to_cuda(params), to_cuda(lora)) if dev == "cuda" \
                else (params, lora)
            srv = ForkServer(cfg, p, lo, sc, device=dev)
            outs, m, _ = serve(srv, cfg.vocab_size, 72, 4, 4, 9, 6, 3,
                               SamplingParams)
            check_serving(outs, m, 6)
            toks[dev] = [o.tokens for o in outs]
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"{mode}: card {toks['cuda']} != CPU "
                                 f"{toks['cpu']}")
        log("small_model", mode=mode, tokens=toks["cuda"], ok=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU "
              "machine", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}; run from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.paper_models import (LLAMA3_8B,
                                                  tiny_serving_model)
    from repro_torch.core.config import ServeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_residual_attention as pra
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.api import ForkServer
    from repro_torch.serving.sampling import SamplingParams

    t_start = time.perf_counter()
    # 1. environment
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("environment", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        python=sys.version.split()[0], allow_tf32=False)

    # 2. build
    t0 = time.perf_counter()
    pra.build()
    log("build", seconds=time.perf_counter() - t0,
        ptxas=_build.BUILD_LOGS.get(pra.SOURCE, "(cached build)"))

    # 3. kernels against their plain versions
    check_kernels(pra, ref)

    # 4. small model: card vs CPU
    small_model_card_vs_cpu(tiny_serving_model, tfm, ForkServer,
                            ServeConfig, SamplingParams)

    # 5./6. Llama3-8B, full width and depth, bf16, random weights
    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0)
    lora = tfm.init_lora_stacks(cfg, 1, 4)
    torch.cuda.synchronize()
    log("init", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        seconds=time.perf_counter() - t0,
        param_gib=sum(t.numel() * t.element_size()
                      for t in list(params["layers"].values()) +
                      [params["embed"], params["unembed"]]) / 2 ** 30)
    launches = {}
    peaks = {}
    shapes = LaunchShapes(pra)
    for mode, kernels in (
            ("forkkv", ("paged_residual_attention_mixed",
                        "paged_residual_attention_decode")),
            ("prefix", ("paged_attention_mixed_base",
                        "paged_attention_decode_base"))):
        sc = ServeConfig(mode=mode, max_pages=2048, max_pages_per_req=256)
        server = ForkServer(cfg, params, lora, sc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(pra, ref)
        with shapes:
            outs, m, seconds = serve(server, cfg.vocab_size, 2048, 8, 4, 64,
                                     16, seed=11, sampling_cls=SamplingParams)
        ran = check_counts(pra, ref, kernels)
        launches.update(ran)
        check_serving(outs, m, 16)
        gen = sum(len(o.tokens) for o in outs)
        peaks[mode] = (m["peak_base_pages"], m["peak_res_pages"])
        log("serve", mode=mode, model=cfg.name, forks=len(outs),
            context=2048, instr=64, new_tokens=16, seconds=seconds,
            tokens_per_s=gen / seconds, ttft_p50_ms=m["ttft_p50_ms"],
            tpot_p50_ms=m["tpot_p50_ms"], steps=m["steps"],
            mixed_steps=m["mixed_steps"], decode_steps=m["decode_steps"],
            avg_decode_batch=m["avg_decode_batch"],
            peak_base_pages=m["peak_base_pages"],
            peak_res_pages=m["peak_res_pages"],
            peak_cache_bytes=m["peak_cache_bytes"],
            hit_kinds=m["hit_kinds"], launches=ran,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            tokens=[o.tokens for o in outs[:2]], ok=True)
        del server
        torch.cuda.empty_cache()
    log("memory_effect", forkkv_peak_base_pages=peaks["forkkv"][0],
        forkkv_peak_res_pages=peaks["forkkv"][1],
        prefix_peak_base_pages=peaks["prefix"][0])
    del params, lora
    torch.cuda.empty_cache()

    # 7. kernels at the serve's launch geometries
    recorded = shapes.launches()
    log("serve_launches", geometries={
        n: sorted({k[:4] for k in v}) for n, v in recorded.items()})
    measured = check_serving_shapes(pra, ref, recorded)

    # 8. kernels line, card line, result line
    kernels = []
    for name, (_, replaces) in KERNELS.items():
        rec = measured[name]
        kernels.append(dict(
            name=name, status="ported", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_residual_attention.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=rec["max_abs_err"], ms=rec["kernel_ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    log("done", seconds=time.perf_counter() - t_start)
    print(card_line())
    print(json.dumps({"kernels": kernels, "todo": [
        dict(name=n, status="todo", replaces=r) for n, r in TODO]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
