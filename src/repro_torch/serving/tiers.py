"""Tiered KV offload: CoW-aware device→host demotion/promotion, blob
codecs and a disk tier (port of ``repro/serving/tiers.py``).

Eviction becomes *demotion*:

  * :class:`HostTier` — a numpy-backed page store with its own byte budget
    and LRU.  Entries hold the exact bytes of one KV page (all layers, K and
    V, and the dequant scales of int8 pages), so a later promotion restores
    the device cache bit-identically.
  * :class:`TieredPagePool` — a façade wrapping the
    :class:`~repro_torch.serving.pool.PagePool`.  It keeps the whole
    refcounted device-page API (``alloc``/``incref``/``decref``/…) and adds
    the tier transitions used by the radix trees:

      - ``demote_node(node)``   device pages → host blobs; the radix node
        stays alive with ``tier == "host"`` and its ``pages`` list holding
        host *handles* instead of device page ids.
      - ``promote_node(node)``  host blobs → freshly allocated device pages
        (applying back-pressure through ``pressure_fn`` when the device
        pool is full); the node returns to ``tier == "device"``.

CoW invariants across tiers (DESIGN.md §10):
  * only pages whose sole reference is the radix tree (refcount == 1) are
    demoted — pages shared with in-flight requests never leave the device;
  * a demoted page is immutable in host memory; one demoted bCache page
    serves every agent that later re-forks it (the promotion re-creates a
    shared, refcounted device page);
  * nodes on a locked radix path (``lock_ref > 0``) are pinned in whichever
    tier they occupy: device eviction skips them and the host LRU refuses
    to drop their entries.

Below the host sits an optional third tier (DESIGN.md §18):

  * blob *codecs* — pluggable transforms applied on demote and reversed
    on promote (``identity`` / ``int8`` per-row-scale quantization /
    ``zstd`` lossless compression), so the host budget holds *stored*
    bytes, not logical bytes;
  * :class:`DiskTier` — a file-backed page store with the same
    handle/owner/LRU contract as :class:`HostTier`.  Host-LRU pressure
    *spills* whole nodes to disk (``tier == "disk"``) instead of
    destroying them; disk-LRU pressure is the true end of the line.

When the host budget is also exhausted the tier degrades to true eviction
(the node and its bytes are destroyed).

numpy has no bfloat16, and this module needs no package that adds one: a
bf16 page is carried as its raw 16-bit patterns in a ``uint16`` array whose
dtype is tagged :data:`BFLOAT16`.  The tag names the array ``"bfloat16"``
in codec metadata and blob-file headers, so files stay byte-compatible with
those the reference writes with ``ml_dtypes``; the int8 codec widens the
bits to f32 exactly (a 16-bit shift) and rounds back to nearest even.
``ZstdCodec`` uses the ``zstandard`` module when importable and stdlib
``zlib`` otherwise, as the reference does (``backend`` says which).
"""
from __future__ import annotations

import itertools
import json
import os
import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

# A blob is one page's worth of cache bytes: a dict of numpy arrays
# (e.g. {"k": (L, page, Hkv, hd), "v": ...}) produced by the executor's
# export_pages and consumed by import_pages.
Blob = Dict[str, np.ndarray]


def blob_bytes(blob: Blob) -> int:
    return sum(int(a.nbytes) for a in blob.values())


# --------------------------------------------------------------------------
# Blob codecs (DESIGN.md §18): encode on demote, decode on promote.
# Encoded blobs are still Dict[str, np.ndarray], so HostTier/DiskTier store
# and account them unchanged — the budget naturally tracks STORED bytes.
# --------------------------------------------------------------------------
# bf16 pages: raw bit patterns in uint16, tagged so the name survives
BFLOAT16 = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def _dtype_name(dt) -> str:
    dt = np.dtype(dt)
    if dt.metadata and "dtype" in dt.metadata:
        return dt.metadata["dtype"]
    return dt.name


def _dtype_from_name(name: str):
    return BFLOAT16 if name == "bfloat16" else np.dtype(name)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """Exact widening of bf16 bit patterns (uint16) to float32."""
    return (np.asarray(bits).view(np.uint16).astype(np.uint32)
            << 16).view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 → bf16 bit patterns, rounded to nearest even (NaN stays a
    quiet NaN), tagged :data:`BFLOAT16`."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    nan = np.isnan(x)
    bits = np.where(nan, (u >> 16) | 0x40, rounded).astype(np.uint16)
    return bits.view(BFLOAT16)


def _as_f32(a: np.ndarray) -> np.ndarray:
    if _dtype_name(a.dtype) == "bfloat16":
        return bf16_to_f32(a)
    return np.asarray(a, np.float32)


def _from_f32(x: np.ndarray, name: str) -> np.ndarray:
    if name == "bfloat16":
        return f32_to_bf16(x)
    return x.astype(np.dtype(name))


def _meta_arr(doc: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(doc).encode(), np.uint8)


def _meta_doc(arr: np.ndarray) -> dict:
    return json.loads(bytes(arr).decode())


class IdentityCodec:
    """Pass-through: stored bytes == logical bytes, bit-identical."""

    name = "identity"
    lossless = True
    deterministic_size = True

    def encode(self, blob: Blob) -> Blob:
        return blob

    def decode(self, blob: Blob) -> Blob:
        return blob


class Int8Codec:
    """Symmetric per-row int8: ``scale = amax(|x|, axis=-1) / 127``.

    Mirrors the dense-cache ``ModelConfig.kv_quant`` math
    (transformer.quantize_kv): one float32 scale per trailing-axis row,
    so a (L, page, Hkv, hd) K blob quantizes per (layer, token, head).
    Lossy with bounded error: |x - deq(q)| <= scale/2 = amax/254 per row.
    Non-float arrays (e.g. already-int8 pool pages) pass through.
    """

    name = "int8"
    lossless = False
    deterministic_size = True

    def encode(self, blob: Blob) -> Blob:
        enc: Blob = {}
        for key, a in blob.items():
            if not np.issubdtype(np.dtype(a.dtype), np.floating) \
                    and _dtype_name(a.dtype) != "bfloat16":
                enc[key] = a
                continue
            x = _as_f32(a)
            scale = np.abs(x).max(axis=-1) / 127.0
            scale = np.maximum(scale, 1e-8)
            q = np.clip(np.round(x / scale[..., None]), -127, 127)
            enc[key + ".q"] = q.astype(np.int8)
            enc[key + ".s"] = scale.astype(np.float32)
            enc[key + ".meta"] = _meta_arr({"dtype": _dtype_name(a.dtype)})
        return enc

    def decode(self, blob: Blob) -> Blob:
        dec: Blob = {}
        for key, a in blob.items():
            if key.endswith(".q"):
                base = key[:-2]
                scale = blob[base + ".s"]
                name = _meta_doc(blob[base + ".meta"])["dtype"]
                dec[base] = _from_f32(a.astype(np.float32)
                                      * scale[..., None], name)
            elif key.endswith(".s") or key.endswith(".meta"):
                continue
            else:
                dec[key] = a
        return dec


class ZstdCodec:
    """Lossless byte compression per array.

    Uses the ``zstandard`` module when importable and falls back to stdlib
    ``zlib`` otherwise — same lossless bit-identical contract, different
    ratio/speed.  ``backend`` records which one is active.
    """

    name = "zstd"
    lossless = True
    deterministic_size = False     # stored size is content-dependent

    def __init__(self):
        try:
            import zstandard
            self._c = zstandard.ZstdCompressor()
            self._d = zstandard.ZstdDecompressor()
            self.backend = "zstandard"
        except ImportError:
            self._c = self._d = None
            self.backend = "zlib"

    def _compress(self, raw: bytes) -> bytes:
        if self._c is not None:
            return self._c.compress(raw)
        return zlib.compress(raw, 6)

    def _decompress(self, data: bytes) -> bytes:
        if self._d is not None:
            return self._d.decompress(data)
        return zlib.decompress(data)

    def encode(self, blob: Blob) -> Blob:
        enc: Blob = {}
        for key, a in blob.items():
            raw = np.ascontiguousarray(a).tobytes()
            enc[key + ".z"] = np.frombuffer(self._compress(raw), np.uint8)
            enc[key + ".meta"] = _meta_arr({"dtype": _dtype_name(a.dtype),
                                            "shape": list(a.shape)})
        return enc

    def decode(self, blob: Blob) -> Blob:
        dec: Blob = {}
        for key, a in blob.items():
            if not key.endswith(".z"):
                continue
            base = key[:-2]
            meta = _meta_doc(blob[base + ".meta"])
            raw = self._decompress(bytes(a))
            dec[base] = np.frombuffer(
                raw, _dtype_from_name(meta["dtype"])).reshape(meta["shape"])
        return dec


_CODECS = {"identity": IdentityCodec, "int8": Int8Codec, "zstd": ZstdCodec}


def get_codec(name: str):
    if name not in _CODECS:
        raise ValueError(f"unknown KV codec {name!r} "
                         f"(choose from {sorted(_CODECS)})")
    return _CODECS[name]()


# --------------------------------------------------------------------------
# Blob file container: explicit dtype-name + shape header, so bfloat16
# arrays round-trip without pickling (np.savez has no bfloat16).
# Shared by DiskTier entries and the persist()/restore() manifest.
# --------------------------------------------------------------------------
def write_blob_file(path: str, blob: Blob) -> int:
    meta = []
    payload = []
    for key, a in blob.items():
        raw = np.ascontiguousarray(a).tobytes()
        meta.append({"key": key, "dtype": _dtype_name(a.dtype),
                     "shape": list(a.shape), "nbytes": len(raw)})
        payload.append(raw)
    hdr = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for raw in payload:
            f.write(raw)
    return 8 + len(hdr) + sum(len(r) for r in payload)


def read_blob_file(path: str) -> Blob:
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        blob: Blob = {}
        for m in meta:
            raw = f.read(m["nbytes"])
            blob[m["key"]] = np.frombuffer(
                raw, _dtype_from_name(m["dtype"])).reshape(m["shape"])
    return blob


class HostTier:
    """Numpy-backed second-tier page store: byte budget + LRU.

    Handles are opaque ints.  Entries carry their *owner* (the
    :class:`TieredPagePool` that demoted them) so a shared HostTier can
    serve several device pools (bCache + rCache) under ONE host budget —
    host DRAM is a single resource.  When the budget overflows, the least
    recently used evictable entry is dropped and the owner is notified via
    ``owner._on_host_evict(handle)`` so it can unlink the radix node.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self.used_bytes = 0
        self._entries: Dict[int, tuple] = {}   # handle -> (blob, nbytes, owner)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._handles = itertools.count(1)
        # counters
        self.put_count = 0
        self.get_count = 0
        self.evicted_entries = 0
        self.evicted_bytes = 0

    def __contains__(self, handle: int) -> bool:
        return handle in self._entries

    @property
    def num_entries(self) -> int:
        return len(self._entries)

    def put(self, blob: Blob, owner=None) -> Optional[int]:
        """Store one page blob; LRU-evict unpinned entries to make room.

        Returns a handle, or None when the blob cannot fit even after
        evicting everything evictable (budget exhausted → caller falls
        back to true eviction).
        """
        nbytes = blob_bytes(blob)
        if nbytes > self.budget_bytes:
            return None
        if self.used_bytes + nbytes > self.budget_bytes:
            # one forward pass over an LRU snapshot — never rescan pinned
            # entries; eviction hooks may drop collateral handles, so
            # skip any that vanished under us
            for h in list(self._lru):
                if self.used_bytes + nbytes <= self.budget_bytes:
                    break
                if h not in self._entries:
                    continue
                _, _, own = self._entries[h]
                if own is None or own.host_can_evict(h):
                    self._evict(h)
            if self.used_bytes + nbytes > self.budget_bytes:
                return None
        handle = next(self._handles)
        self._entries[handle] = (blob, nbytes, owner)
        self._lru[handle] = None
        self.used_bytes += nbytes
        self.put_count += 1
        return handle

    def _evict(self, handle: int) -> None:
        blob, nbytes, owner = self._entries.pop(handle)
        self._lru.pop(handle, None)
        self.used_bytes -= nbytes
        self.evicted_entries += 1
        self.evicted_bytes += nbytes
        if owner is not None:
            # the popped blob rides along so the owner can spill it to the
            # disk tier instead of losing the bytes (DESIGN.md §18)
            owner._on_host_evict(handle, blob)

    def get(self, handle: int) -> Blob:
        blob, _, _ = self._entries[handle]
        self._lru.move_to_end(handle)
        self.get_count += 1
        return blob

    def touch(self, handle: int) -> None:
        if handle in self._lru:
            self._lru.move_to_end(handle)

    def can_admit(self, nbytes: int) -> bool:
        """Could ``nbytes`` fit after evicting every unpinned entry?

        Demotion reserves its FULL blob total through this before storing
        anything: pinned (locked-node) entries don't count as evictable,
        so a demote that cannot complete never destroys other nodes'
        entries as collateral on the way to failing.
        """
        free = self.budget_bytes - self.used_bytes
        if nbytes <= free:
            return True
        evictable = sum(nb for h, (_, nb, own) in self._entries.items()
                        if own is None or own.host_can_evict(h))
        return nbytes <= free + evictable

    def free(self, handle: int) -> None:
        """Idempotent: freeing an already-evicted handle is a no-op."""
        if handle not in self._entries:
            return
        _, nbytes, _ = self._entries.pop(handle)
        self._lru.pop(handle, None)
        self.used_bytes -= nbytes


class DiskTier:
    """File-backed third-tier page store: byte budget + LRU, same
    handle/owner contract as :class:`HostTier`.

    Entries are blob files under ``root``; ``used_bytes`` counts the
    on-disk (stored, post-codec) sizes.  ``io_hook`` is an injectable
    pre-IO callable (the engine wires the ``disk_io`` fault site through
    it): a raising hook or a failing filesystem surfaces as an exception
    from ``put``/``get``, which the owning :class:`TieredPagePool`
    degrades — spill failure drops the node, promote failure truncates
    the match — never crashing the pump (DESIGN.md §17/§18).
    """

    def __init__(self, root: str, budget_bytes: int,
                 io_hook: Optional[Callable[[], None]] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.budget_bytes = int(budget_bytes)
        self.io_hook = io_hook
        self.used_bytes = 0
        self._entries: Dict[int, tuple] = {}  # handle -> (path, nbytes, owner)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._handles = itertools.count(1)
        self.put_count = 0
        self.get_count = 0
        self.evicted_entries = 0
        self.evicted_bytes = 0

    def __contains__(self, handle: int) -> bool:
        return handle in self._entries

    @property
    def num_entries(self) -> int:
        return len(self._entries)

    def put(self, blob: Blob, owner=None) -> Optional[int]:
        """Write one blob file; LRU-evict to make room.  Returns None when
        the blob cannot fit; raises on IO failure (caller degrades)."""
        est = blob_bytes(blob)
        if est > self.budget_bytes:
            return None
        if self.used_bytes + est > self.budget_bytes:
            for h in list(self._lru):
                if self.used_bytes + est <= self.budget_bytes:
                    break
                if h not in self._entries:
                    continue
                _, _, own = self._entries[h]
                if own is None or own.disk_can_evict(h):
                    self._evict(h)
            if self.used_bytes + est > self.budget_bytes:
                return None
        handle = next(self._handles)
        path = os.path.join(self.root, f"page_{handle:08d}.blob")
        if self.io_hook is not None:
            self.io_hook()
        nbytes = write_blob_file(path, blob)
        self._entries[handle] = (path, nbytes, owner)
        self._lru[handle] = None
        self.used_bytes += nbytes
        self.put_count += 1
        return handle

    def _evict(self, handle: int) -> None:
        path, nbytes, owner = self._entries.pop(handle)
        self._lru.pop(handle, None)
        self.used_bytes -= nbytes
        self.evicted_entries += 1
        self.evicted_bytes += nbytes
        try:
            os.unlink(path)
        except OSError:
            pass
        if owner is not None:
            owner._on_disk_evict(handle)

    def get(self, handle: int) -> Blob:
        path, _, _ = self._entries[handle]
        self._lru.move_to_end(handle)
        self.get_count += 1
        if self.io_hook is not None:
            self.io_hook()
        return read_blob_file(path)

    def touch(self, handle: int) -> None:
        if handle in self._lru:
            self._lru.move_to_end(handle)

    def can_admit(self, nbytes: int) -> bool:
        free = self.budget_bytes - self.used_bytes
        if nbytes <= free:
            return True
        evictable = sum(nb for h, (_, nb, own) in self._entries.items()
                        if own is None or own.disk_can_evict(h))
        return nbytes <= free + evictable

    def free(self, handle: int) -> None:
        if handle not in self._entries:
            return
        path, nbytes, _ = self._entries.pop(handle)
        self._lru.pop(handle, None)
        self.used_bytes -= nbytes
        try:
            os.unlink(path)
        except OSError:
            pass


class TieredPagePool:
    """Façade over a device :class:`PagePool` adding a host demotion tier.

    Exposes the full PagePool API (the radix trees and the engine keep
    using it unchanged) plus the demote/promote transitions.  Device↔host
    byte movement is delegated to callbacks bound by the engine:

      export_fn(pages)        -> [blob, ...]   device → host copies
      import_fn(pages, blobs)                  host → device copies
      pressure_fn(n)                           free ≥ n device pages
                                               (tree LRU evict/demote)

    ``codec`` transforms blobs on the way in/out of the host tier
    (identity/int8/zstd — DESIGN.md §18); ``disk`` adds the third tier:
    host-LRU pressure spills whole nodes to it instead of destroying
    them, and promotion reads disk-tier nodes straight back to device.
    """

    is_tiered = True

    def __init__(self, pool, host: HostTier,
                 export_fn: Optional[Callable] = None,
                 import_fn: Optional[Callable] = None,
                 pressure_fn: Optional[Callable[[int], int]] = None,
                 promote_limit: int = 0,
                 codec=None, disk: Optional[DiskTier] = None):
        self.pool = pool
        self.host = host
        self.disk = disk
        self.codec = codec if codec is not None else IdentityCodec()
        self.export_fn = export_fn
        self.import_fn = import_fn
        self.pressure_fn = pressure_fn
        self.promote_limit = promote_limit   # max pages promoted per match
        self._node_of: Dict[int, object] = {}  # host handle -> radix Node
        self._node_of_disk: Dict[int, object] = {}  # disk handle -> Node
        self._match_promoted = 0
        self._page_nbytes: Optional[int] = None  # stored size, learned once
        # counters
        self.tier_hits = 0            # promote events (one per node)
        self.disk_hits = 0            # promote events served from disk
        self.demoted_pages = 0
        self.demoted_bytes = 0        # logical bytes demoted
        self.promoted_pages = 0
        self.promoted_bytes = 0       # logical bytes promoted
        self.spilled_pages = 0        # host → disk spills
        self.host_evicted_pages = 0   # pages truly lost from the host tier
        self.disk_evicted_pages = 0   # pages truly lost from the disk tier
        self.dropped_device_pages = 0  # device pages lost to host-LRU cascade
        self.demote_failures = 0
        self.promote_failures = 0
        self.io_errors = 0            # export/import raised (DESIGN.md §17)
        self.codec_logical_bytes = 0  # pre-codec bytes entering the host
        self.codec_stored_bytes = 0   # post-codec bytes actually stored

    def bind(self, export_fn: Callable, import_fn: Callable,
             pressure_fn: Optional[Callable[[int], int]] = None) -> None:
        self.export_fn = export_fn
        self.import_fn = import_fn
        self.pressure_fn = pressure_fn

    # -------------------------------------------------- PagePool façade
    def can_alloc(self, n: int) -> bool:
        return self.pool.can_alloc(n)

    def alloc(self, n: int) -> Optional[List[int]]:
        return self.pool.alloc(n)

    def incref(self, pages: Sequence[int]) -> None:
        self.pool.incref(pages)

    def decref(self, pages: Sequence[int]) -> List[int]:
        return self.pool.decref(pages)

    def refcount(self, page: int) -> int:
        return self.pool.refcount(page)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return self.pool.pages_for_tokens(n_tokens)

    @property
    def num_pages(self) -> int:
        return self.pool.num_pages

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    @property
    def name(self) -> str:
        return self.pool.name

    @property
    def used_pages(self) -> int:
        return self.pool.used_pages

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def utilization(self) -> float:
        return self.pool.utilization

    @property
    def alloc_count(self) -> int:
        return self.pool.alloc_count

    @property
    def oom_count(self) -> int:
        return self.pool.oom_count

    # ---------------------------------------------------- tier bridging
    def begin_match(self) -> None:
        """Reset the per-match promotion budget (``tier_promote_limit``)."""
        self._match_promoted = 0

    def promote_room(self) -> Optional[int]:
        """Pages the current match may still promote (None = unlimited).
        The matcher splits oversized host nodes at this boundary so a node
        larger than the whole limit still promotes incrementally."""
        if not self.promote_limit:
            return None
        return max(0, self.promote_limit - self._match_promoted)

    def host_can_evict(self, handle: int) -> bool:
        """Host LRU guard: entries of locked (in-use) or session-pinned
        nodes are untouchable."""
        node = self._node_of.get(handle)
        return node is None or (node.lock_ref == 0 and node.pin_ref == 0)

    def disk_can_evict(self, handle: int) -> bool:
        """Disk LRU guard — same lock/pin contract as the host tier."""
        node = self._node_of_disk.get(handle)
        return node is None or (node.lock_ref == 0 and node.pin_ref == 0)

    def demote_node(self, node) -> bool:
        """Copy a node's device pages to the host tier and free them.

        CoW guard: only applies when the tree is the sole owner of every
        page (refcount == 1).  On success the node survives with
        ``tier == "host"`` and ``pages`` holding host handles.  Returns
        False (caller falls back to true eviction) when the export path is
        unbound, a page is still shared, or the host budget is exhausted.
        """
        pages = list(node.pages)
        if not pages or self.export_fn is None:
            return False
        if node.pin_ref > 0:
            # session-pinned context: immune to demotion too — a live
            # session's whole point is keeping its prefix hot on device
            return False
        if any(self.pool.refcount(p) != 1 for p in pages):
            return False
        # Pin the WHOLE ancestor chain, not just the victim: host.put may
        # LRU-evict a host-tier ancestor, whose _drop_subtree would reach
        # down and free this node's device pages mid-demote (double free).
        # Locks cover the whole path — same convention as match_prefix.
        chain = []
        n = node
        while n is not None:
            n.lock_ref += 1
            chain.append(n)
            n = n.parent
        try:
            # STORED blob size per page is deterministic for size-stable
            # codecs (identity/int8): once learned, a doomed demote is
            # rejected BEFORE paying the device→host export + encode it
            # would only throw away.  zstd sizes are content-dependent, so
            # the authoritative post-encode check below decides alone.
            if self._page_nbytes is not None and not self.host.can_admit(
                    len(pages) * self._page_nbytes):
                self.demote_failures += 1
                return False
            try:
                blobs = self.export_fn(pages)
            except Exception:
                # IO fault (DESIGN.md §17): nothing was moved — the node
                # keeps its device pages and the caller falls back to
                # true eviction, so a flaky export degrades to the seed's
                # destroy-on-evict instead of crashing the pump
                self.io_errors += 1
                self.demote_failures += 1
                return False
            logical = sum(blob_bytes(b) for b in blobs)
            blobs = [self.codec.encode(b) for b in blobs]
            stored = sum(blob_bytes(b) for b in blobs)
            if self.codec.deterministic_size:
                self._page_nbytes = blob_bytes(blobs[0])
            # admission reserves what will actually be STORED — reserving
            # logical (pre-codec) sizes would over-evict peers and
            # under-fill the budget (the accounting bug this PR fixes)
            if not self.host.can_admit(stored):
                # the node cannot fit (budget too small, or the remainder
                # is pinned): fail before the put loop evicts other nodes'
                # entries as collateral for a doomed demote
                self.demote_failures += 1
                return False
            handles: List[int] = []
            for blob in blobs:
                h = self.host.put(blob, self)
                if h is None:
                    for hh in handles:
                        self._node_of.pop(hh, None)
                        self.host.free(hh)
                    self.demote_failures += 1
                    return False
                self._node_of[h] = node
                handles.append(h)
            self.pool.decref(pages)              # device pages become free
            node.pages = handles
            node.tier = "host"
            self.demoted_pages += len(pages)
            self.demoted_bytes += logical
            self.codec_logical_bytes += logical
            self.codec_stored_bytes += stored
            return True
        finally:
            for n in chain:
                n.lock_ref -= 1

    def promote_node(self, node) -> bool:
        """Copy a host-tier node back into freshly allocated device pages.

        The caller must hold a lock on the node (match does), which pins
        its host entries while ``pressure_fn`` makes room on the device.
        On success the node is a normal device node again, its pages owned
        by the tree (refcount 1).  Returns False when the promote budget
        for this match is spent or the device pool stays full — the match
        then truncates (partial hit), never corrupts.
        """
        handles = list(node.pages)
        n = len(handles)
        if n == 0 or self.import_fn is None:
            return False
        if self.promote_limit and self._match_promoted + n > self.promote_limit:
            self.promote_failures += 1
            return False
        from_disk = node.tier == "disk"
        store = self.disk if from_disk else self.host
        node_of = self._node_of_disk if from_disk else self._node_of
        for h in handles:
            store.touch(h)
        pages = self.pool.alloc(n)
        if pages is None and self.pressure_fn is not None:
            self.pressure_fn(n - self.pool.free_pages)
            pages = self.pool.alloc(n)
        if pages is None:
            self.promote_failures += 1
            return False
        try:
            blobs = [self.codec.decode(store.get(h)) for h in handles]
            self.import_fn(pages, blobs)
        except Exception:
            # IO fault (disk read or device import): give back the device
            # pages just allocated; the stored entries are untouched, so
            # the node stays a valid host/disk-tier node and the match
            # truncates (partial hit) — the request recomputes the suffix
            # instead of dying
            self.pool.decref(pages)
            self.io_errors += 1
            self.promote_failures += 1
            return False
        for h in handles:
            node_of.pop(h, None)
            store.free(h)
        node.pages = pages
        node.tier = "device"
        self.tier_hits += 1
        if from_disk:
            self.disk_hits += 1
        self.promoted_pages += n
        self._match_promoted += n
        self.promoted_bytes += sum(blob_bytes(b) for b in blobs)
        return True

    def host_put_blobs(self, blobs: Sequence[Blob]) -> Optional[List[int]]:
        """Encode and store logical blobs in the host tier (restore path).
        All-or-nothing: on any failure the already-stored entries are
        freed and None is returned."""
        enc = [self.codec.encode(b) for b in blobs]
        stored = sum(blob_bytes(b) for b in enc)
        if not self.host.can_admit(stored):
            return None
        handles: List[int] = []
        for b in enc:
            h = self.host.put(b, self)
            if h is None:
                for hh in handles:
                    self._node_of.pop(hh, None)
                    self.host.free(hh)
                return None
            handles.append(h)
        logical = sum(blob_bytes(b) for b in blobs)
        self.codec_logical_bytes += logical
        self.codec_stored_bytes += stored
        return handles

    def adopt_host_handles(self, handles: Sequence[int], node) -> None:
        """Register restored host handles as owned by ``node`` (so host-LRU
        eviction and spill find their radix node)."""
        for h in handles:
            self._node_of[h] = node

    def retarget(self, handles: Sequence[int], node) -> None:
        """Re-own handles after a radix node split moved them to a new node.
        Splits happen in whichever tier the node occupies, so both handle
        namespaces are checked."""
        for h in handles:
            if node.tier == "disk":
                if h in self._node_of_disk:
                    self._node_of_disk[h] = node
            elif h in self._node_of:
                self._node_of[h] = node

    def _on_host_evict(self, handle: int, blob: Optional[Blob] = None) -> None:
        """Host LRU dropped one of our entries.  With a disk tier bound,
        the owning node SPILLS — its whole blob set moves to disk files and
        the node survives with ``tier == "disk"``.  Without one (or when
        the spill fails), the node and any children go with it — the
        pre-§18 behaviour."""
        node = self._node_of.pop(handle, None)
        if node is None:
            return
        if self.disk is not None and node.tier == "host" \
                and self._spill_node_to_disk(node, handle, blob):
            return
        self._drop_subtree(node)

    def _spill_node_to_disk(self, node, handle: int,
                            blob: Optional[Blob]) -> bool:
        """Move one host-tier node's blobs to the disk tier.  ``handle``
        was already popped from the host store; its blob rides in by
        value.  Children stay attached whatever their tier."""
        blobs = []
        for h in node.pages:
            if h == handle:
                if blob is None:
                    return False
                blobs.append(blob)
            elif h in self.host:
                blobs.append(self.host.get(h))
            else:
                return False       # partially-gone node: cannot spill
        if not self.disk.can_admit(sum(blob_bytes(b) for b in blobs)):
            return False
        dhandles: List[int] = []
        try:
            for b in blobs:
                dh = self.disk.put(b, self)
                if dh is None:
                    raise OSError("disk tier full")
                self._node_of_disk[dh] = node
                dhandles.append(dh)
        except Exception:
            # disk write failed (IO fault or budget): roll back and let the
            # caller drop the node — degrade, don't crash
            for dh in dhandles:
                self._node_of_disk.pop(dh, None)
                self.disk.free(dh)
            self.io_errors += 1
            return False
        for h in node.pages:
            if h != handle:
                self._node_of.pop(h, None)
                self.host.free(h)
        self.spilled_pages += len(dhandles)
        node.pages = dhandles
        node.tier = "disk"
        return True

    def _on_disk_evict(self, handle: int) -> None:
        """Disk LRU dropped an entry: the end of the line — the owning
        node (and any children) is destroyed."""
        node = self._node_of_disk.pop(handle, None)
        if node is None:
            return
        self._drop_subtree(node)

    def _drop_subtree(self, node) -> None:
        """Destroy a radix subtree whose bytes are gone (true eviction of
        host-tier state).  Safe on mixed subtrees: device descendants give
        their pages back to the device pool.

        Never reachable for in-use state: a locked node implies a locked
        ancestor chain (match and demote both pin root→node), so
        ``host_can_evict`` refuses every entry above it — asserted here
        so a future violation fails loudly instead of double-freeing."""
        assert node.lock_ref == 0, "dropping a locked (in-use) radix node"
        assert node.pin_ref == 0, "dropping a session-pinned radix node"
        for child in list(node.children.values()):
            self._drop_subtree(child)
        if node.tier == "host":
            self.host_evicted_pages += len(node.pages)
            for h in node.pages:
                self._node_of.pop(h, None)
                self.host.free(h)       # idempotent: triggering handle gone
        elif node.tier == "disk":
            self.disk_evicted_pages += len(node.pages)
            for h in node.pages:
                self._node_of_disk.pop(h, None)
                self.disk.free(h)       # idempotent: triggering handle gone
        elif node.pages:
            self.dropped_device_pages += len(node.pages)
            self.pool.decref(node.pages)
        if node.parent is not None:
            node.parent.children.pop(node.key[0], None)
        node.pages = []
        node.children = {}

    def stats(self) -> Dict[str, int]:
        return {
            "tier_hits": self.tier_hits,
            "disk_hits": self.disk_hits,
            "demoted_pages": self.demoted_pages,
            "demoted_bytes": self.demoted_bytes,
            "promoted_pages": self.promoted_pages,
            "promoted_bytes": self.promoted_bytes,
            "spilled_pages": self.spilled_pages,
            "host_evicted_pages": self.host_evicted_pages,
            "disk_evicted_pages": self.disk_evicted_pages,
            "dropped_device_pages": self.dropped_device_pages,
            "demote_failures": self.demote_failures,
            "promote_failures": self.promote_failures,
            "tier_io_errors": self.io_errors,
            "codec_logical_bytes": self.codec_logical_bytes,
            "codec_stored_bytes": self.codec_stored_bytes,
        }
