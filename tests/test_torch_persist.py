"""Codecs, the disk tier and persist/restore in the port (port of
``tests/test_persist.py``), and a restore of a manifest the JAX engine
persisted.

  * codec round trips — identity/zstd are bit-identical for f32 and for
    bf16 (carried as tagged 16-bit patterns, bit for bit the reference's
    ``ml_dtypes`` values); int8 is lossy within its per-row bound;
  * blob files — bf16 arrays round-trip, and files are byte-compatible
    with the reference's in both directions;
  * disk spill, disk-IO faults, persist/restore token parity under every
    codec, geometry mismatch, the engine under a ``disk_io`` fault plan,
    and the linear percentile — as the reference's tests hold them;
  * a manifest persisted by the reference's engine (bf16 pages, and int8
    pages with their scales) restores into the port: the promoted pages
    are the reference's bytes and the greedy continuation is the
    reference's after its own restore.

Every directory is a ``tmp_path``; everything runs on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import tiny_serving_model as jtiny
from repro.core.config import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving import tiers as jtiers
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import bridge
from repro_torch.configs.paper_models import tiny_serving_model
from repro_torch.core.config import ServeConfig
from repro_torch.serving import tiers
from repro_torch.serving.engine import Engine, Request, percentile
from repro_torch.serving.pool import PagePool
from repro_torch.serving.radix import RadixTree
from repro_torch.serving.tiers import (DiskTier, HostTier, TieredPagePool,
                                       blob_bytes, get_codec, read_blob_file,
                                       write_blob_file)

PAGE = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _f32(a):
    """Values of a blob array as f32 (bf16 bit patterns widened)."""
    if tiers._dtype_name(a.dtype) == "bfloat16":
        return tiers.bf16_to_f32(a)
    return np.asarray(a, np.float32)


# ----------------------------------------------------------------- codecs
def _blob(rng, dtype):
    x = rng.standard_normal((2, 8, 4)).astype(np.float32)
    y = rng.standard_normal((2, 8, 4)).astype(np.float32)
    if dtype == "bfloat16":
        return {"k": tiers.f32_to_bf16(x), "v": tiers.f32_to_bf16(y)}
    return {"k": x, "v": y}


def test_bf16_bits_are_the_reference_values():
    """``f32_to_bf16`` rounds as ``ml_dtypes`` does (nearest even, NaN and
    inf kept), and ``bf16_to_f32`` widens exactly."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 7,
                        np.float32([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                    3.0e38, 1.0 + 2.0 ** -8])])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16))
    got = tiers.f32_to_bf16(x)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(tiers.bf16_to_f32(got),
                                  want.astype(np.float32))
    assert np.isnan(tiers.bf16_to_f32(tiers.f32_to_bf16(
        np.float32([np.nan])))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["identity", "zstd", "int8"])
def test_codec_roundtrip_matrix(name, dtype):
    codec = get_codec(name)
    rng = np.random.default_rng(0)
    blob = _blob(rng, dtype)
    dec = codec.decode(codec.encode(blob))
    assert set(dec) == set(blob)
    for key in blob:
        assert dec[key].dtype == blob[key].dtype
        assert tiers._dtype_name(dec[key].dtype) == dtype
        assert dec[key].shape == blob[key].shape
        if codec.lossless:
            np.testing.assert_array_equal(
                dec[key].view(np.uint8), blob[key].view(np.uint8))
        else:   # int8: |x - deq| <= scale/2 = amax(|row|)/254 per row,
            # plus the half-ulp of casting the dequantized value back to
            # a narrow storage dtype (bf16 half-ulp <= |x| * 2^-8)
            x = _f32(blob[key])
            bound = np.abs(x).max(axis=-1, keepdims=True) / 254.0 + 1e-6
            if dtype == "bfloat16":
                bound = bound + np.abs(x) * 2.0 ** -8
            err = np.abs(_f32(dec[key]) - x)
            assert (err <= bound).all(), err.max()


def test_int8_codec_matches_the_reference_on_bf16():
    """The int8 codec on bf16 pages stores and restores the reference's
    exact bytes (the reference widens with ``ml_dtypes``, the port by a
    16-bit shift)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    jb = {"k": np.asarray(jnp.asarray(x, jnp.bfloat16))}
    tb = {"k": tiers.f32_to_bf16(x)}
    jenc, tenc = jtiers.get_codec("int8").encode(jb), \
        get_codec("int8").encode(tb)
    for key in ("k.q", "k.s", "k.meta"):
        np.testing.assert_array_equal(tenc[key], jenc[key])
    jdec = jtiers.get_codec("int8").decode(jenc)["k"]
    tdec = get_codec("int8").decode(tenc)["k"]
    np.testing.assert_array_equal(tdec.view(np.uint16),
                                  jdec.view(np.uint16))


def test_int8_codec_passes_through_integer_arrays():
    """Already-quantized pool pages (kv_quant="int8" blobs carry int8
    "k"/"v" plus f32 "ks"/"vs") must not be double-quantized."""
    codec = get_codec("int8")
    q = np.arange(-64, 64, dtype=np.int8).reshape(8, 16)
    dec = codec.decode(codec.encode({"k": q}))
    assert dec["k"].dtype == np.int8
    np.testing.assert_array_equal(dec["k"], q)


@pytest.mark.parametrize("backend", ["zstandard", "zlib"])
def test_zstd_codec_compresses_redundant_data(backend, monkeypatch):
    """Both backends: ``zstandard`` where it is installed, stdlib ``zlib``
    where it is not (the reference's own documented fallback)."""
    if backend == "zlib":
        import builtins
        real = builtins.__import__

        def no_zstandard(name, *a, **kw):
            if name == "zstandard":
                raise ImportError(name)
            return real(name, *a, **kw)
        monkeypatch.setattr(builtins, "__import__", no_zstandard)
    codec = get_codec("zstd")
    if backend == "zstandard" and codec.backend != "zstandard":
        pytest.skip("the zstandard module is not installed here")
    assert codec.backend == backend
    blob = {"k": np.zeros((64, 64), np.float32),
            "b": tiers.f32_to_bf16(np.ones((64, 64), np.float32))}
    enc = codec.encode(blob)
    assert blob_bytes(enc) < blob_bytes(blob) // 10
    dec = codec.decode(enc)
    for key in blob:
        np.testing.assert_array_equal(dec[key].view(np.uint8),
                                      blob[key].view(np.uint8))


def test_blob_file_roundtrips_bfloat16(tmp_path):
    rng = np.random.default_rng(1)
    blob = {"k": tiers.f32_to_bf16(rng.standard_normal((4, 8))),
            "meta": np.arange(3, dtype=np.int32)}
    path = str(tmp_path / "page.blob")
    nbytes = write_blob_file(path, blob)
    assert nbytes > 0
    back = read_blob_file(path)
    assert set(back) == set(blob)
    for key in blob:
        assert back[key].dtype == blob[key].dtype
        assert tiers._dtype_name(back[key].dtype) == \
            tiers._dtype_name(blob[key].dtype)
        np.testing.assert_array_equal(
            back[key].view(np.uint8), blob[key].view(np.uint8))


def test_blob_files_are_byte_compatible_with_the_reference(tmp_path):
    """A file the reference writes (``ml_dtypes`` bf16) is the file the
    port writes for the same values, and each side reads the other's."""
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    jblob = {"k": np.asarray(jnp.asarray(x, jnp.bfloat16)),
             "s": x, "q": np.arange(6, dtype=np.int8)}
    tblob = {"k": tiers.f32_to_bf16(x), "s": x,
             "q": np.arange(6, dtype=np.int8)}
    jpath, tpath = str(tmp_path / "j.blob"), str(tmp_path / "t.blob")
    jtiers.write_blob_file(jpath, jblob)
    write_blob_file(tpath, tblob)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    from_j = read_blob_file(jpath)
    assert tiers._dtype_name(from_j["k"].dtype) == "bfloat16"
    np.testing.assert_array_equal(from_j["k"].view(np.uint16),
                                  tblob["k"].view(np.uint16))
    from_t = jtiers.read_blob_file(tpath)
    assert from_t["k"].dtype == jblob["k"].dtype
    np.testing.assert_array_equal(from_t["k"].view(np.uint16),
                                  jblob["k"].view(np.uint16))


# --------------------------------------------------------------- disk tier
class FakeDeviceStore:
    def __init__(self, num_pages, elems=8):
        self.data = np.zeros((num_pages, elems), np.float32)

    def export(self, pages):
        return [{"x": self.data[p].copy()} for p in pages]

    def import_(self, pages, blobs):
        for p, b in zip(pages, blobs):
            self.data[p] = b["x"]


def make_tiered3(tmp_path, host_budget, disk_budget=1 << 20,
                 num_pages=16, io_hook=None):
    store = FakeDeviceStore(num_pages)
    host = HostTier(host_budget)
    disk = DiskTier(str(tmp_path / "disk"), disk_budget, io_hook=io_hook)
    pool = TieredPagePool(PagePool(num_pages, PAGE), host,
                          export_fn=store.export, import_fn=store.import_,
                          disk=disk)
    tree = RadixTree(pool)
    pool.pressure_fn = tree.evict
    return tree, pool, store, host, disk


def insert_seq(tree, pool, store, toks, fill):
    pages = pool.alloc(len(toks) // PAGE)
    for i, p in enumerate(pages):
        store.data[p] = fill * 100 + i
    tree.insert(toks, pages)
    pool.decref(pages)
    return pages


def test_host_pressure_spills_to_disk_and_promotes_back(tmp_path):
    # host fits exactly ONE 2-page node (2 x 32B blobs)
    tree, pool, store, host, disk = make_tiered3(tmp_path, host_budget=64)
    a, b = list(range(8)), list(range(100, 108))
    pa = insert_seq(tree, pool, store, a, fill=1)
    snapshot = {p: store.data[p].copy() for p in pa}
    insert_seq(tree, pool, store, b, fill=2)
    assert tree.evict(2) == 2                   # a -> host
    assert tree.evict(2) == 2                   # b -> host, a SPILLS to disk
    assert pool.spilled_pages == 2
    assert disk.num_entries == 2 and host.num_entries == 2
    assert pool.dropped_device_pages == 0       # nothing was destroyed
    store.data[:] = -1
    got, matched, _ = tree.match_prefix(a)      # promote straight from disk
    assert matched == 8
    assert pool.disk_hits == 1 and pool.tier_hits == 1
    for old, new in zip(pa, got):
        np.testing.assert_array_equal(store.data[new], snapshot[old])
    assert disk.num_entries == 0                # disk copy consumed
    _, mb, _ = tree.match_prefix(b)             # b still on host
    assert mb == 8


def test_disk_put_fault_degrades_to_drop(tmp_path):
    """A failing spill write rolls back and drops the node instead of
    crashing the host-LRU eviction path."""
    def boom():
        raise OSError("injected disk fault")
    tree, pool, store, host, disk = make_tiered3(tmp_path, host_budget=64,
                                                 io_hook=boom)
    a, b = list(range(8)), list(range(100, 108))
    insert_seq(tree, pool, store, a, fill=1)
    insert_seq(tree, pool, store, b, fill=2)
    assert tree.evict(2) == 2
    assert tree.evict(2) == 2                   # spill of a fails -> dropped
    assert pool.io_errors >= 1 and pool.spilled_pages == 0
    assert disk.num_entries == 0
    _, ma, _ = tree.match_prefix(a)
    assert ma == 0                              # a is gone, not corrupt
    _, mb, _ = tree.match_prefix(b)
    assert mb == 8                              # b unharmed on host


def test_disk_get_fault_truncates_promote(tmp_path):
    """A failing disk read during promotion truncates the match; the
    on-disk node stays intact and a later healthy read still promotes
    it."""
    fail = []

    def flaky():
        if fail:
            raise OSError("injected disk fault")
    tree, pool, store, host, disk = make_tiered3(tmp_path, host_budget=64,
                                                 io_hook=flaky)
    a, b = list(range(8)), list(range(100, 108))
    pa = insert_seq(tree, pool, store, a, fill=1)
    snapshot = {p: store.data[p].copy() for p in pa}
    insert_seq(tree, pool, store, b, fill=2)
    tree.evict(2)
    tree.evict(2)                               # a on disk (healthy writes)
    fail.append(True)
    _, matched, _ = tree.match_prefix(a)
    assert matched == 0                         # truncated, not crashed
    assert pool.promote_failures == 1 and pool.io_errors == 1
    assert disk.num_entries == 2                # node survived the fault
    fail.clear()
    store.data[:] = -1
    got, matched, _ = tree.match_prefix(a)
    assert matched == 8 and pool.disk_hits == 1
    for old, new in zip(pa, got):
        np.testing.assert_array_equal(store.data[new], snapshot[old])


# --------------------------------------------------------- persist/restore
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The reference's tiny serving model (rank 8, 16 adapters) in f32,
    bf16 and f32 with int8 bCache pages: JAX's weights and their bridged
    torch copies, keyed by that setting."""
    out = {}
    for key, change in (("float32", {}), ("bfloat16", dict(dtype="bfloat16")),
                        ("int8", dict(kv_quant="int8"))):
        jcfg = dataclasses.replace(jtiny(rank=8), **change)
        jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        jlora = jtfm.init_lora_stacks(jcfg, jax.random.PRNGKey(1),
                                      n_adapters=16)
        tcfg = dataclasses.replace(tiny_serving_model(rank=8), **change)
        out[key] = ((jcfg, jparams, jlora),
                    (tcfg, bridge.params_from_jax(_np(jparams), "cpu"),
                     bridge.lora_from_jax(_np(jlora), "cpu")))
    return out


def run_one(engine, adapter, prompt, max_new=6, request=Request):
    req = request(rid=0, adapter_id=adapter, prompt=list(prompt),
                  max_new_tokens=max_new)
    engine.submit(req)
    while req.state != "done":
        engine.step()
    return req


def _sc(persist_dir, cls=ServeConfig, **kw):
    base = dict(page_size=16, max_pages=256, max_batch=4,
                max_prefill_tokens=64, mode="forkkv",
                max_pages_per_req=12, host_tier_bytes=64 << 20,
                persist_dir=str(persist_dir))
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("codec", ["identity", "zstd", "int8"])
def test_persist_restore_token_parity(models, tmp_path, codec):
    """Acceptance: a new engine restoring a persisted manifest continues
    the same agent context with IDENTICAL greedy tokens, served from the
    tier (tier_hits > 0) instead of a full re-prefill — under every
    codec, since persisted blobs are stored logical (decoded)."""
    cfg, params, lora = models["float32"][1]
    rng = np.random.default_rng(0)
    ctx = list(rng.integers(0, cfg.vocab_size, 64))
    probe = ctx + list(rng.integers(0, cfg.vocab_size, 8))

    eng1 = Engine(cfg, params, lora, _sc(tmp_path, kv_codec=codec),
                  device="cpu")
    run_one(eng1, adapter=3, prompt=ctx)         # populate the radix tree
    ref = run_one(eng1, adapter=3, prompt=probe)  # unbroken-run continuation
    n = eng1.persist()
    assert n > 0

    eng2 = Engine(cfg, params, lora, _sc(tmp_path, kv_codec=codec),
                  device="cpu")
    assert eng2.restore() == n                   # every page rehydrated
    req = run_one(eng2, adapter=3, prompt=probe)
    assert req.output == ref.output, "restored context diverged"
    m = eng2.metrics()
    assert m["restored_pages"] == n
    assert m["tier_hits"] > 0
    # the shared 64-token context came from the tier, not recompute
    assert req.prefilled_tokens < len(probe)


def test_restore_rejects_mismatched_geometry(models, tmp_path):
    cfg, params, lora = models["float32"][1]
    eng1 = Engine(cfg, params, lora, _sc(tmp_path), device="cpu")
    rng = np.random.default_rng(1)
    run_one(eng1, 2, list(rng.integers(0, cfg.vocab_size, 48)))
    assert eng1.persist() > 0
    eng2 = Engine(cfg, params, lora, _sc(tmp_path, mode="prefix"),
                  device="cpu")
    assert eng2.restore() == 0                   # mode mismatch: skip, no crash


def test_engine_survives_disk_io_fault_plan(models, tmp_path):
    """Engine-level ``disk_io`` fault injection: spills/promotes degrade
    (drop or truncate) and the run still completes every request."""
    cfg, params, lora = models["float32"][1]
    sc = _sc(tmp_path, host_tier_bytes=1 << 20, disk_tier_bytes=32 << 20,
             fault_plan="disk_io:p0.5", fault_seed=7)
    eng = Engine(cfg, params, lora, sc, device="cpu")
    rng = np.random.default_rng(2)
    for i in range(4):
        req = run_one(eng, adapter=i + 1,
                      prompt=list(rng.integers(0, cfg.vocab_size, 64)))
        assert req.output and req.finish_reason == "length"


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_restore_of_a_reference_manifest(models, tmp_path, pages):
    """The reference's engine persists its context (bf16 pages, or int8
    pages with their scales); the port restores that manifest.  Promoting
    the context puts the reference's exact bytes into the port's pools,
    and the greedy continuation equals the reference's after its own
    restore."""
    (jcfg, jp, jl), (tcfg, tp, tl) = models[pages]
    rng = np.random.default_rng(3)
    ctx = [int(t) for t in rng.integers(0, jcfg.vocab_size, 64)]
    probe = ctx + [int(t) for t in rng.integers(0, jcfg.vocab_size, 8)]
    jeng = JEngine(jcfg, jp, jl, _sc(tmp_path, JServeConfig))
    run_one(jeng, 3, ctx, request=JRequest)
    n = jeng.persist()
    assert n > 0
    jfork = jeng.dual.fork(ctx, 3, lock=False)
    jpools = jeng.executor.pools

    jeng2 = JEngine(jcfg, jp, jl, _sc(tmp_path, JServeConfig))
    assert jeng2.restore() == n
    jout = run_one(jeng2, 3, probe, request=JRequest).output

    eng = Engine(tcfg, tp, tl, _sc(tmp_path), device="cpu")
    assert eng.restore() == n
    fork = eng.dual.fork(ctx, 3, lock=False)     # promotes the context
    assert fork.reuse_len == jfork.reuse_len > 0
    pools = eng.executor.pools
    names = [("kb", "base"), ("vb", "base"), ("kr", "res"), ("vr", "res")]
    if pages == "int8":
        names += [("kb_s", "base"), ("vb_s", "base")]
    for name, kind in names:
        ids = fork.base_pages if kind == "base" else fork.res_pages
        jids = jfork.base_pages if kind == "base" else jfork.res_pages
        got = getattr(pools, name)[:, list(ids)]
        want = np.asarray(getattr(jpools, name)[:, np.asarray(jids)])
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)
    req = run_one(eng, 3, probe)
    assert req.output == jout
    m = eng.metrics()
    assert m["restored_pages"] == n and m["tier_hits"] > 0
    assert req.prefilled_tokens < len(probe)


# -------------------------------------------------------------- percentile
def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(3)
    vals = sorted(rng.standard_normal(37).tolist())
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert percentile(vals, q) == pytest.approx(
            np.percentile(vals, q * 100), abs=1e-12)
    assert percentile([], 0.99) == 0.0
    assert percentile([4.2], 0.99) == 4.2
    # the regression: p99 of a small window must NOT be the window max
    small = sorted(rng.standard_normal(20).tolist())
    assert percentile(small, 0.99) < max(small)
    assert percentile(small, 0.99) == pytest.approx(
        np.percentile(small, 99))
