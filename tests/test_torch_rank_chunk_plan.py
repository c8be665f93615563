"""The chunked prefill tile's plan (``flash::ChunkPipe`` in
``csrc/rank_chunk.cuh``), mirrored in
``repro_torch.kernels.residual_attention``: the block -> (row, kv head, q
tile, cluster rank) map of #7's ``residual_attention_chunk_kernel`` and
#5/#1's ``paged_prefill_res_chunk_kernel``, the rebuild's share per CTA
of a cluster, and the shared memory of every instance the dispatchers
can choose against the H100's 232,448 bytes per CTA.  The kernels
themselves run on the card only (``chip_smoke.py``)."""
from collections import Counter, defaultdict

import pytest

from repro_torch.kernels import residual_attention as tra

H100_SMEM_PER_CTA = 232448
CLUSTER_SIZES = (1, 2, 4)


@pytest.mark.parametrize("nc", CLUSTER_SIZES)
@pytest.mark.parametrize("ntiles", range(1, 34))
def test_cluster_map_covers_every_tile_once(ntiles, nc):
    """Every (row, kv head, q tile) has exactly one CTA; the rest are
    padding CTAs (tile None), ntiles rounded up to whole clusters."""
    hkv, bsz = 3, 2
    grid = tra.chunk_prefill_map(ntiles, hkv, bsz, nc)
    clusters = -(-ntiles // nc)
    assert len(grid) == clusters * hkv * bsz * nc
    seen = Counter((b, h, t) for b, h, t, _ in grid if t is not None)
    want = {(b, h, t) for b in range(bsz) for h in range(hkv)
            for t in range(ntiles)}
    assert set(seen) == want and set(seen.values()) == {1}
    padding = sum(t is None for _, _, t, _ in grid)
    assert padding == (clusters * nc - ntiles) * hkv * bsz


@pytest.mark.parametrize("nc", CLUSTER_SIZES)
@pytest.mark.parametrize("ntiles", range(1, 34))
def test_cluster_map_clusters_and_heavy_first(ntiles, nc):
    """A cluster is ``nc`` consecutive blocks of one (row, kv head) with
    ranks 0..nc-1 and consecutive tiles, the latest at rank 0; a (row, kv
    head)'s tiles come in falling order, so the heaviest launch first;
    padding CTAs sit only at the end of its last cluster."""
    hkv, bsz = 2, 3
    grid = tra.chunk_prefill_map(ntiles, hkv, bsz, nc)
    for c0 in range(0, len(grid), nc):
        cluster = grid[c0:c0 + nc]
        assert len({(b, h) for b, h, _, _ in cluster}) == 1
        assert [r for _, _, _, r in cluster] == list(range(nc))
        tiles = [t for _, _, t, _ in cluster]
        live = [t for t in tiles if t is not None]
        assert live and tiles[:len(live)] == live
        assert live == list(range(live[0], live[0] - len(live), -1))
    order = defaultdict(list)
    for b, h, t, _ in grid:
        order[(b, h)].append(t)
    for tiles in order.values():
        live = [t for t in tiles if t is not None]
        assert live == sorted(live, reverse=True)
        assert tiles[:len(live)] == live       # padding at the very end
    # every (row, kv head)'s first cluster launches before any second one
    first_slot = [i // (hkv * bsz * nc) for i, (_, _, t, _) in
                  enumerate(grid) if t == ntiles - 1]
    assert set(first_slot) == {0}


@pytest.mark.parametrize("d", (32, 64, 120, 128, 256))
@pytest.mark.parametrize("nc", CLUSTER_SIZES)
def test_rebuild_share_covers_k_and_v_once(d, nc):
    """The CTAs of a cluster rebuild every (K or V, n-tile pair) of a key
    block exactly once between them, each the same number of pairs."""
    if d > 128 and nc < 4:
        # D 256 runs clusters of 4 whatever CLUSTER_CTAS says
        assert tra.chunk_cluster_ctas(d) == 4
        nc = 4
    owned = Counter()
    sizes = set()
    for rank in range(nc):
        kinds, pairs = tra.chunk_rebuild_share(d, nc, rank)
        sizes.add(len(kinds) * len(pairs))
        owned.update((k, j) for k in kinds for j in pairs)
    tile = tra.tile_dim(d)
    assert set(owned) == {(k, j) for k in "kv" for j in range(tile // 16)}
    assert set(owned.values()) == {1} and len(sizes) == 1


DENSE_DIMS = (32, 64, 120, 128, 256)
PAGED_DIMS = (32, 64, 120, 128)
RANKS = (65, 128, 256)


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("d", DENSE_DIMS)
def test_dense_instance_fits(d, r):
    """#7's chunked instance at every head_dim fits the CTA with at least
    two stages, at every rank above 64 (nothing on chip grows with R)."""
    assert tra.rank_chunked(r)
    nc = tra.chunk_cluster_ctas(d)
    smem = tra.chunk_prefill_smem(d, dense=True)
    assert smem <= H100_SMEM_PER_CTA
    assert tra.chunk_prefill_stages(d, dense=True) >= 2
    assert smem == tra.chunk_prefill_smem(
        d, True, nc=nc, stages=tra.chunk_prefill_stages(d, True))


@pytest.mark.parametrize("int8", (False, True))
@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("d", PAGED_DIMS)
def test_paged_instance_fits(d, r, int8):
    """#5/#1's chunked instance, bf16 and int8 pages, fits the CTA with at
    least two stages at every rank above 64."""
    assert tra.rank_chunked(r)
    smem = tra.chunk_prefill_smem(d, dense=False, int8=int8)
    assert smem <= H100_SMEM_PER_CTA
    assert tra.chunk_prefill_stages(d, False, int8) >= 2


@pytest.mark.parametrize("int8", (False, True))
@pytest.mark.parametrize("nc", CLUSTER_SIZES)
@pytest.mark.parametrize("d", PAGED_DIMS)
def test_cluster_variants_fit(d, nc, int8):
    """Every cluster size the variants script builds fits two stages up to
    tile width 128, dense (bf16) and paged."""
    assert tra.chunk_prefill_smem(d, False, int8, nc=nc, stages=2) <= \
        H100_SMEM_PER_CTA
    if not int8:
        assert tra.chunk_prefill_smem(d, True, nc=nc, stages=2) <= \
            H100_SMEM_PER_CTA


def test_main_instances():
    """The bytes and stages of the instances the main path's cases run
    (Llama3-8B's D 128 in clusters of 4: 128-column rank chunks, two
    stages; D 64: three; RecurrentGemma-9B's D 256: 32-key blocks and
    64-column chunks, two stages), as the source reckons them."""
    assert tra.CLUSTER_CTAS == 4 and tra.CHUNK_STAGES == 3
    assert tra.PIPE_CHUNK == 128
    assert tra.chunk_prefill_smem(128, dense=True) == 211584
    assert tra.chunk_prefill_stages(128, dense=True) == 2
    assert tra.chunk_prefill_smem(128, dense=False) == 211008
    assert tra.chunk_prefill_smem(128, dense=False, int8=True) == 209472
    assert tra.chunk_prefill_stages(64, dense=True) == 3
    assert tra.chunk_prefill_smem(256, dense=True) == 213632
    assert tra.chunk_prefill_stages(256, dense=True) == 2
    # one CTA alone at D 256 would need 246,400 bytes for two stages
    assert tra.chunk_prefill_smem(256, True, nc=1, stages=2) > \
        H100_SMEM_PER_CTA


@pytest.mark.parametrize("sq,tq,clusters", ((1000, 32, 8), (512, 32, 4),
                                            (130, 32, 2), (1000, 8, 32)))
def test_main_path_clusters(sq, tq, clusters):
    """#7's 4 x 1000 rows at Llama3-8B's G 4 (tq 32) and RecurrentGemma-9B's
    G 16 (tq 8), #5's 512-row chunk, and the 130-row edge case: clusters
    per (row, kv head) in groups of 4 tiles."""
    ntiles = -(-sq // tq)
    grid = tra.chunk_prefill_map(ntiles, 1, 1, 4)
    assert len(grid) == clusters * 4
