"""The collectives a sharded step issues, as ``launch/roofline.py``'s
``collective_bytes`` counts them and the dry run records them.

``collective_bytes`` against hand counts on a 2x2 ("data", "model") mesh
over torch's ``"fake"`` process group (one row-sharded matmul; an
embedding lookup through ``core/shards.lookup`` in each table layout,
forward and backward), the dry run's count solved from two cut depths
(``dryrun.count_collectives``) against a direct count of the whole step
(a decode step at full depth; a remat train step on the multi-pod mesh),
a 1x1 mesh counting none, and a cache write that issues none.  The
numbers these layouts compute are held to the plain operations on four
gloo processes in ``tests/test_torch_sharded_steps.py``.
"""
import faulthandler
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import configs as cfg_lib
from repro_torch.core import shards
from repro_torch.core.config import LoRAConfig, ModelConfig, ShapeConfig, \
    shape_by_name
from repro_torch.launch import dryrun, mesh as tmesh, roofline, steps
from repro_torch.models import base
from repro_torch.models.registry import get_model

WORLD, GRID = 4, (2, 2)
PG_TIMEOUT = timedelta(seconds=60)       # every collective of the group
STACK_S = 240                            # a hang prints every stack


@pytest.fixture(autouse=True, scope="module")
def _stacks_on_hang():
    """A test of this module that hangs prints every thread's stack."""
    faulthandler.dump_traceback_later(STACK_S, exit=False)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def fake_2x2():
    with tmesh.fake_world(WORLD):
        yield init_device_mesh("cpu", GRID, mesh_dim_names=("data",
                                                            "model"))


def _counts(**kinds):
    out = dict.fromkeys(roofline.COLL_OPS, 0)
    out.update({k.replace("_", "-"): v for k, v in kinds.items()})
    out["count"] = sum(1 for v in kinds.values() if v)
    out["total"] = sum(kinds.values())
    return out


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_collective_bytes_counts_a_row_sharded_matmul_by_hand(fake_2x2,
                                                              device):
    """x (B, K) and w (K, N) both sharded on K over "model": the local
    products are partial sums, and making them whole is one all-reduce of
    the (B, N) f32 partial, B·N·4 bytes per device."""
    b, k, n = 8, 64, 32
    x = distribute_tensor(torch.ones(b, k, device=device), fake_2x2,
                          (Replicate(), Shard(1)), src_data_rank=None)
    w = distribute_tensor(torch.ones(k, n, device=device), fake_2x2,
                          (Replicate(), Shard(0)), src_data_rank=None)
    got = roofline.collective_bytes(
        lambda a, c: (a @ c).redistribute(fake_2x2, (Replicate(),) * 2),
        x, w)
    assert got == {"all-gather": 0, "all-reduce": b * n * 4,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0, "count": 1,
                   "total": b * n * 4}
    assert got["total"] == sum(got[k] for k in roofline.COLL_OPS)


V, D, IB, IS = 256, 64, 8, 16            # table (V, D), ids (IB, IS)
ROWS_LOCAL = IB // 2 * IS * D * 4        # one data shard's rows, f32
LOOKUPS = {
    # FSDP: the table's d over "data", its rows over "model".  The table
    # gathered over "data" (its (V/2, D/2) shard), the rows whole over
    # "model" (one all-reduce); the gradient reduce-scattered back
    "fsdp": ((Shard(1), Shard(0)), (Shard(0), Replicate()),
             _counts(all_gather=V // 2 * D // 2 * 4,
                     all_reduce=ROWS_LOCAL),
             _counts(reduce_scatter=V // 2 * D * 4)),
    # the rows over the ids' mesh dim: the ids gathered (int64), all rows
    # made whole over "data"; each shard's gradient is its own rows'
    "rows": ((Shard(0), Replicate()), (Replicate(), Replicate()),
             _counts(all_gather=IB // 2 * IS * 8,
                     all_reduce=2 * ROWS_LOCAL),
             _counts()),
    # the rows over "model" only (a decode step's vocab): one all-reduce;
    # the gradient stays a partial sum over the ids' shards
    "vocab": ((Replicate(), Shard(0)), (Shard(0), Replicate()),
              _counts(all_reduce=ROWS_LOCAL), _counts()),
}


@pytest.mark.parametrize("layout", sorted(LOOKUPS))
def test_a_lookup_issues_what_its_layout_needs(fake_2x2, layout):
    """``shards.lookup`` of ids (8, 16) sharded over "data" in a (256, 64)
    f32 table: the ids' sharding kept (no activation gathered), and the
    collectives of each table layout, forward and backward, by hand."""
    placements, rows_pl, fwd, bwd = LOOKUPS[layout]
    table = distribute_tensor(torch.empty(V, D, device="meta"), fake_2x2,
                              placements,
                              src_data_rank=None).requires_grad_()
    ids = distribute_tensor(torch.zeros(IB, IS, dtype=torch.long,
                                        device="meta"), fake_2x2,
                            (Shard(0), Replicate()), src_data_rank=None)
    got = {}

    def forward():
        with steps.sharded():
            got["rows"] = shards.lookup(table, ids)

    def backward():
        with steps.sharded():
            got["rows"].sum().backward()

    assert roofline.collective_bytes(forward) == fwd
    expect = rows_pl if layout == "rows" else (Shard(0), Replicate())
    assert got["rows"].placements == expect
    assert got["rows"].shape == (IB, IS, D)
    assert roofline.collective_bytes(backward) == bwd
    assert table.grad.shape == (V, D)


def _direct(cfg, shape, mesh, **kw):
    built = steps.build_step(cfg, mesh, shape, **kw)
    return roofline.collective_bytes(steps.run_sharded, built, mesh,
                                     *steps.shard_args(built, mesh))


def test_solved_count_equals_the_full_depth_count():
    """internlm2-1.8b ``decode_32k`` on the single-pod mesh: the count
    solved from two cut depths equals the step counted at all 24 layers,
    byte for byte and collective for collective."""
    cfg = cfg_lib.get_config("internlm2-1.8b")
    shape = shape_by_name("decode_32k")
    with tmesh.fake_world(256):
        mesh = tmesh.make_production_mesh()
        solved, how = dryrun.count_collectives(cfg, shape, mesh)
        direct = _direct(cfg, shape, mesh)
    assert how["depths"] == [2, 4] and how["layers"] == 24
    assert solved == direct
    assert direct["count"] > 0 and direct["total"] == sum(
        direct[k] for k in roofline.COLL_OPS)


@pytest.mark.parametrize("multi,layers", [(False, 24), (True, 6)],
                         ids=["single-24", "multi-6"])
def test_solved_count_of_a_remat_train_step_equals_the_direct_count(
        multi, layers):
    """internlm2-1.8b ``train_4k`` (remat on) in one microbatch, whole on
    the single-pod mesh and cut to 6 layers on the multi-pod one (where
    DTensor's choices differ between odd and even depths; on both its
    first layer differs from the later ones): the count solved from 2 and
    4 layers equals the whole step's, split, microbatch and optimizer
    update included."""
    cfg = dryrun._cut(cfg_lib.get_config("internlm2-1.8b"), layers)
    assert cfg.remat
    shape = shape_by_name("train_4k")
    with tmesh.fake_world(512 if multi else 256):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        solved, how = dryrun.count_collectives(cfg, shape, mesh, accum=1)
        direct = _direct(cfg, shape, mesh, accum=1)
    assert how == {"depths": [2, 4], "layers": layers, "microbatches": 1,
                   "accum": 1}
    assert solved == direct and direct["count"] > 0


@pytest.mark.parametrize("arch,layers,mode,depths", [
    ("internlm2-1.8b", 24, "decode", (2, 4)),
    ("internlm2-1.8b", 25, "decode", (3, 5)),
    ("internlm2-1.8b", 4, "decode", (4, 4)),
    ("recurrentgemma-9b", 38, "train", (8, 14))])
def test_cut_depths_share_the_parity_of_the_model(arch, layers, mode,
                                                  depths):
    """Both cut depths are at least 2 and share L's parity; the hybrid's
    pattern of 3 makes the period 6; a model of at most d + p layers is
    counted whole."""
    cfg = dryrun._cut(cfg_lib.get_config(arch), layers)
    assert dryrun.count_depths(cfg, mode) == depths


def test_a_1x1_mesh_counts_no_collective():
    """The tiny dense serve step through the DTensor path on
    ``make_local_mesh("cpu")``: no collective, and the plain call's ids."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="float32", lora=LoRAConfig(rank=8))
    api = get_model(cfg)
    rng = np.random.default_rng(7)

    def draw(tree):
        return base.tree_map(lambda t: torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.05)
            if t.is_floating_point() else torch.zeros(t.shape, dtype=t.dtype),
            tree)

    b, s = 2, 24
    args = (draw(api.init_params(0, device="meta")),
            draw(api.init_lora_stacks(0, steps.N_ADAPTERS, device="meta")),
            draw(api.init_cache(b, s, disagg=True, device="meta")),
            torch.tensor([5, 9], dtype=torch.int32),
            torch.tensor([s - 7, s - 1], dtype=torch.int32),
            torch.tensor([3, 6], dtype=torch.int32))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)
    try:
        mesh = tmesh.make_local_mesh("cpu")
        built = steps.build_step(cfg, mesh, ShapeConfig("decode", s, b,
                                                        "decode"),
                                 disagg=True)
        plain_ids = built.step_fn(*base.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            args))[0]
        got = {}

        def run(*dargs):
            got["out"] = steps.run_sharded(built, mesh, *dargs)

        counted = roofline.collective_bytes(
            run, *steps.shard_args(built, mesh, args))
    finally:
        dist.destroy_process_group()
    assert counted["count"] == 0 and counted["total"] == 0
    assert torch.equal(got["out"][0].full_tensor(), plain_ids)


@pytest.mark.parametrize("rows", ["as_the_cache", "replicated"])
def test_a_cache_write_issues_no_collective(fake_2x2, rows):
    """``shards.write_rows`` into a (Shard(0), Shard(2)) cache: each shard
    writes its own rows, in place, whether the new rows come laid out as
    the cache or whole (this process is rank 0: its shard holds batch rows
    0-1 and KV head 0)."""
    cache = distribute_tensor(torch.zeros(4, 16, 2, 8), fake_2x2,
                              (Shard(0), Shard(2)), src_data_rank=None)
    new = torch.ones(4, 1, 2, 8)
    slot = torch.full((4, 1), 5, dtype=torch.int32)
    if rows == "as_the_cache":
        new = distribute_tensor(new, fake_2x2, (Shard(0), Shard(2)),
                                src_data_rank=None)
        slot = distribute_tensor(slot, fake_2x2, (Shard(0), Replicate()),
                                 src_data_rank=None)
    local = cache.to_local()
    got = roofline.collective_bytes(shards.write_rows, cache, slot, new)
    assert got["count"] == 0
    assert cache.placements == (Shard(0), Shard(2))
    assert cache.to_local().data_ptr() == local.data_ptr()
    assert local.shape == (2, 16, 1, 8)
    assert bool((local[:, 5] == 1).all())
    assert float(local.sum()) == 2 * 8
