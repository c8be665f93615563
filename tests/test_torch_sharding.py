"""The port's dry-run and sharding layer against the JAX package's (port of
``tests/test_sharding_and_roofline.py``).

The reference's spec cases with the same expectations; ``spec_for_axes``
equal to the reference's (its ``PartitionSpec`` as a tuple) for every leaf
of every arch's parameter, LoRA, cache (disaggregated or not) and
optimizer-state trees on both production meshes, for each purpose and
strategy; the logical-axis trees equal to the reference's, key for key;
``analytic_costs`` equal to the reference's for every applicable pair on
both meshes and strategies; the roofline terms on the H100's constants;
the FLOP counter against the analytic model and across depths (where the
reference's ``cost_analysis`` counts a scanned layer stack once, the
port's ``FlopCounterMode`` counts every layer); a train step's one-pass
count equal to its microbatched count; the blocked attention loops' meta
paths count what the loops compute, forward and backward;
and, on a fake 16 x 16 mesh of 256 ranks in this process, the local
shapes of Llama3-8B's trees equal to what DTensor computes.
"""
import dataclasses
import functools

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro import configs as jconfigs
from repro.core.config import shape_by_name as jshape_by_name
from repro.launch import analytic as janalytic
from repro.launch import sharding as jshd
from repro.models.registry import get_model as jget_model
from repro.training import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.paper_models import LLAMA3_8B
from repro_torch.core import attention as tattn
from repro_torch.core.config import (HBM_BW, LINK_BW, MULTI_POD,
                                     PEAK_FLOPS_BF16, SINGLE_POD,
                                     INPUT_SHAPES, LoRAConfig, ModelConfig,
                                     shape_by_name)
from repro_torch.launch import analytic, mesh as tmesh, roofline
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as topt

MESH_SIZES = {"data": 16, "model": 16}
MESH_SIZES_MP = {"pod": 2, "data": 16, "model": 16}
META = torch.device("meta")


def spec(axes, shape, sizes=None, cfg=None, purpose="train"):
    rules = shd.rules_for(cfg, purpose)
    return shd.spec_for_axes(axes, shape, sizes or MESH_SIZES, rules)


# ------------------------------------------- the reference's spec cases
def test_basic_tp_fsdp_spec():
    assert spec(("embed", "q_out"), (4096, 4096)) == ("data", "model")
    assert spec(("layers", "embed", "ff"), (32, 4096, 14336)) == \
        (None, "data", "model")


def test_divisibility_fallback_llama4_heads():
    # llama4: 40 q heads not divisible by 16 -> heads unsharded
    assert spec(("heads",), (40,)) == ()
    # kv_heads=8 indivisible -> model lands on head_dim instead
    s = spec(("layers", "batch", None, "kv_heads", "kv_head_dim"),
             (48, 128, 32768, 8, 128))
    assert s == (None, "data", None, None, "model")


def test_batch_joint_pod_data():
    s = spec(("batch",), (256,), MESH_SIZES_MP)
    assert s == (("pod", "data"),)
    # batch=1 (long_500k): unshardable -> replicated
    assert spec(("batch",), (1,), MESH_SIZES_MP) == ()


def test_decode_big_model_2d_tp():
    cfg = tconfigs.get_config("llama3-405b")
    s = spec(("embed", "q_out"), (16384, 16384), MESH_SIZES_MP, cfg,
             "decode")
    assert s == (None, ("pod", "data", "model"))


def test_no_mesh_axis_used_twice():
    s = spec(("q_out", "kv_out", "ff"), (4096, 1024, 14336))
    flat = [a for e in s if e for a in (e if isinstance(e, tuple) else (e,))]
    assert len(flat) == len(set(flat))


def test_placements_shard_a_joint_dim_on_both_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements((("pod", "data"), None, "model"),
                          ("pod", "data", "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.placements(("data",), ("pod", "data", "model")) == \
        (Replicate(), Shard(0), Replicate())
    assert shd.local_shape((256, 7, 32), (("pod", "data"), None, "model"),
                           MESH_SIZES_MP) == (8, 7, 2)


def test_mesh_configs_are_the_references():
    from repro.core import config as jcore
    for mine, theirs in ((SINGLE_POD, jcore.SINGLE_POD),
                         (MULTI_POD, jcore.MULTI_POD)):
        assert (mine.shape, mine.axes, mine.num_devices) == \
            (theirs.shape, theirs.axes, theirs.num_devices)
    assert tmesh.mesh_axis_sizes(MULTI_POD) == MESH_SIZES_MP


# -------------------------------- every leaf of every arch, against JAX
def _jtuple(p):
    return tuple(p)


def _axes_leaves(axes):
    """(path, leaf) of a logical-axes tree: tuples or None are leaves."""
    if isinstance(axes, dict):
        return [((k,) + p, a) for k in axes for p, a in
                _axes_leaves(axes[k])]
    if isinstance(axes, list):
        return [((i,) + p, a) for i, x in enumerate(axes) for p, a in
                _axes_leaves(x)]
    return [((), axes)]


def _pairs(tree, axes):
    """(shape, axes leaf) for every tensor of ``tree``."""
    out = []
    shd.map_leaves(lambda t, a: out.append((tuple(t.shape), a)), tree, axes)
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The port's meta trees of ``arch`` and their axes, with the
    reference's axes for the same leaves: params, LoRA stacks, caches of
    decode_32k's batch (disaggregated or not; int8 for the transformer
    family) and the optimizer state."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    api, japi = get_model(cfg), jget_model(jcfg)
    params = api.init_params(0, device=META)
    trees = [("params", params, api.logical_axes(), japi.logical_axes())]
    init = topt.get_optimizer(cfg.optimizer)[0]
    opt = init(params)
    trees.append(("opt", opt,
                  topt.OptState(None, topt.opt_state_logical_axes(
                      cfg.optimizer, api.logical_axes())),
                  jopt.OptState(None, jopt.opt_state_logical_axes(
                      jcfg.optimizer, japi.logical_axes()))))
    if api.init_lora_stacks is not None:
        trees.append(("lora", api.init_lora_stacks(0, 8, device=META),
                      api.lora_logical_axes(), japi.lora_logical_axes()))
    shape = shape_by_name("decode_32k")
    for disagg in (False, True):
        trees.append((f"cache disagg={disagg}",
                      api.init_cache(shape.global_batch, shape.seq_len,
                                     disagg=disagg, device=META),
                      api.cache_logical_axes(disagg=disagg),
                      japi.cache_logical_axes(disagg=disagg)))
    if cfg.family in ("dense", "moe", "vlm"):
        c8 = dataclasses.replace(cfg, kv_quant="int8")
        j8 = dataclasses.replace(jcfg, kv_quant="int8")
        trees.append(("cache int8", get_model(c8).init_cache(
            4, 64, disagg=True, device=META),
            get_model(c8).cache_logical_axes(disagg=True),
            jget_model(j8).cache_logical_axes(disagg=True)))
    return cfg, jcfg, trees


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_logical_axes_are_the_references(arch):
    cfg, jcfg, trees = _trees(arch)
    for name, _, mine, theirs in trees:
        if name == "opt":
            mine, theirs = mine.inner, theirs.inner
        assert mine == theirs, (arch, name)
        assert sorted(_axes_leaves(mine), key=repr) == \
            sorted(_axes_leaves(theirs), key=repr)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_spec_for_every_leaf_is_the_references(arch):
    cfg, jcfg, trees = _trees(arch)
    n = 0
    for sizes in (MESH_SIZES, MESH_SIZES_MP):
        for purpose in ("train", "prefill", "decode"):
            for strategy in jshd.STRATEGIES:
                rules = shd.rules_for(cfg, purpose, strategy)
                jrules = jshd.rules_for(jcfg, purpose, strategy)
                assert rules == jrules
                for name, tree, axes, jaxes in trees:
                    mine = _pairs(tree, axes)
                    theirs = _pairs(tree, jaxes)
                    for (shp, ax), (_, jax_) in zip(mine, theirs):
                        got = shd.spec_for_axes(ax, shp, sizes, rules)
                        want = jshd.spec_for_axes(jax_, shp, sizes, jrules)
                        assert got == _jtuple(want), (arch, name, ax, shp)
                        n += 1
    assert n > 0


def test_vector_batch_and_input_shardings_are_the_references():
    cfg, jcfg = tconfigs.get_config("llama3-405b"), \
        jconfigs.get_config("llama3-405b")

    class FakeMesh:
        axis_names = ("pod", "data", "model")

        class devices:
            shape = (2, 16, 16)
            size = 512

    for shape in INPUT_SHAPES:
        b = shape.global_batch
        for purpose in ("train", "prefill", "decode"):
            got = shd.vector_sharding(MULTI_POD, b, cfg, purpose).spec
            rules = jshd.rules_for(jcfg, purpose)
            want = jshd.spec_for_axes(("batch",), (b,), MESH_SIZES_MP, rules)
            assert got == _jtuple(want)
        assert shd.batch_sharding_for(MULTI_POD, b) == \
            jshd.batch_sharding_for(FakeMesh, b)
        specs = tconfigs.input_specs(cfg, shape)
        got = shd.input_shardings(MESH_SIZES_MP, specs, cfg, shape.mode)
        for k, s in specs.items():
            axes = ("batch",) + (None,) * (s.dim() - 1)
            want = jshd.spec_for_axes(axes, tuple(s.shape), MESH_SIZES_MP,
                                      jshd.rules_for(jcfg, shape.mode))
            assert got[k].spec == _jtuple(want)


# ------------------------------------------------------------ analytic
class _JMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)
        size = 256


class _JMeshMP:
    axis_names = ("pod", "data", "model")

    class devices:
        shape = (2, 16, 16)
        size = 512


@pytest.mark.parametrize("strategy", ["baseline", "optimized"])
def test_analytic_costs_are_the_references(strategy):
    n = 0
    for arch, shape_name in jconfigs.applicable_pairs():
        cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for sizes, jmesh in ((MESH_SIZES, _JMesh), (MESH_SIZES_MP, _JMeshMP)):
            got = analytic.analytic_costs(cfg, shape_by_name(shape_name),
                                          sizes, strategy=strategy)
            want = janalytic.analytic_costs(
                jcfg, jshape_by_name(shape_name), jmesh, strategy=strategy)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-12), \
                    (arch, shape_name, k)
            assert got["flops_dev"] > 0 and got["bytes_dev"] > 0
            n += 1
    assert n == 66


def test_roofline_terms_on_the_cards_constants():
    t = roofline.roofline_terms(PEAK_FLOPS_BF16, HBM_BW * 2, LINK_BW * 0.5,
                                chips=1)
    assert t["dominant"] == "memory_s"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["bound_s"] == t["memory_s"]
    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (989e12, 3.35e12, 50e9)


# ------------------------------------------------------- FLOP counting
def _probe(layers):
    return ModelConfig(name="probe", family="dense", num_layers=layers,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                       vocab_size=512, dtype="float32",
                       lora=LoRAConfig(rank=8), scan_layers=False,
                       remat=False)


def _forward_flops(cfg, B=2, S=64):
    api = get_model(cfg)
    params = api.init_params(0, device=META)
    toks = torch.empty((B, S), dtype=torch.int32, device=META)
    flops, _ = roofline.step_flops(lambda p, t: api.forward(p, t),
                                   params, toks)
    return flops


def test_flop_counter_matches_the_analytic_model():
    """The reference holds its analytic FLOPs to XLA's cost analysis of an
    unrolled 3-layer model within 25%; the port holds them to
    FlopCounterMode over the same model's forward on meta tensors."""
    cfg = _probe(3)
    ana = analytic.forward_flops(cfg, 2, 64)
    assert 0.75 < ana / _forward_flops(cfg) < 1.33


def test_flop_counter_counts_every_layer():
    """Where the reference's ``cost_analysis`` counts a scanned layer stack
    once (``test_cost_analysis_counts_scan_once``: 2 layers count as many
    FLOPs as 6), the counter sees every layer: 6 layers count about 3x
    what 2 do (the embedding and unembedding are counted once)."""
    two, six = _forward_flops(_probe(2)), _forward_flops(_probe(6))
    assert 2.5 < six / two < 3.0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-large-v3",
                                  "llama4-maverick-400b-a17b"])
def test_one_pass_count_equals_the_microbatched_count(arch):
    """The dry run counts a train step as one pass of the whole batch
    (``accum=1``); the step it prices runs the batch in microbatches, with
    remat on.  Both count the same FLOPs, for the hybrid's block pattern,
    the encoder-decoder's two stacks and llama4's dense/MoE interleave."""
    cfg = dataclasses.replace(tconfigs.get_tiny_config(arch), remat=True)
    shape = dataclasses.replace(shape_by_name("train_4k"), seq_len=32,
                                global_batch=4)

    def count(accum):
        built = steps.build_step(cfg, MESH_SIZES, shape, accum=accum)
        return roofline.step_flops(built.step_fn, *built.abstract_args)[0]

    assert count(1) == pytest.approx(count(4), rel=1e-12)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("kind", ["flash", "flash window", "banded"])
def test_meta_paths_count_what_the_loops_compute(kind, backward):
    """The blocked attention loops on meta tensors run their products in
    one call each; FlopCounterMode counts the same FLOPs as over the loops
    on the CPU, on ragged block edges and with the residual rebuilt once
    per q block, and with a backward (a train step's) through them."""
    from torch.utils.flop_counter import FlopCounterMode

    def count(dev):
        g = torch.Generator().manual_seed(0)

        def mk(*s):
            return torch.randn(*s, generator=g).to(dev).requires_grad_(
                backward)
        B, S, Hq, Hkv, D, R = 1, 1300, 4, 2, 16, 8
        q, k, v = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)
        res = dict(k_res=mk(B, S, R), v_res=mk(B, S, R),
                   b_k=mk(B, R, Hkv * D), b_v=mk(B, R, Hkv * D))
        pos = torch.arange(S, device=dev).expand(B, S)
        with FlopCounterMode(display=False) as c:
            if kind == "banded":
                o = tattn.banded_window_attention(q, k, v, window=300, **res)
            elif kind == "flash":
                o = tattn.flash_attention(q, k, v, qpos=pos, kpos=pos, **res)
            else:
                o = tattn.flash_attention(q, k, v, qpos=pos, kpos=pos,
                                          window=200)
            if backward:
                o.float().sum().backward()
        return c.get_total_flops(), tuple(o.shape)

    assert count("meta") == count("cpu")


# ---------------------------------------------- meshes over DeviceMesh
@pytest.fixture
def fake_256():
    with tmesh.fake_world(256):
        yield tmesh.make_production_mesh()
    assert not dist.is_initialized()


def test_production_mesh_refuses_a_missing_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()


def test_local_shapes_are_what_dtensor_computes(fake_256):
    mesh = fake_256
    assert tmesh.mesh_axis_sizes(mesh) == MESH_SIZES
    with pytest.raises(RuntimeError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)
    cfg = LLAMA3_8B
    api = get_model(cfg)
    shape = shape_by_name("decode_32k")
    params = api.init_params(0, device=META)
    trees = [(params, api.logical_axes(), "train"),
             (api.init_lora_stacks(0, 8, device=META),
              api.lora_logical_axes(), "decode"),
             (api.init_cache(shape.global_batch, 4096, disagg=True,
                             device=META),
              api.cache_logical_axes(disagg=True), "decode")]
    n = 0
    for tree, axes, purpose in trees:
        shards = shd.tree_shardings(mesh, tree, axes, cfg, purpose)

        def check(t, sh):
            nonlocal n
            want, _ = compute_local_shape_and_global_offset(
                tuple(t.shape), mesh, list(sh.placements))
            assert shd.local_shape(t.shape, sh.spec,
                                   MESH_SIZES) == tuple(want)
            n += 1
        shd.map_leaves(check, tree, shards)
    assert n > 20
