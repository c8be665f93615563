"""The port's built steps run sharded.

``launch/steps.py``'s ``shard_args``/``run_sharded`` on a 2x2 ("data",
"model") mesh of four gloo processes on the CPU: the tiny dense model's
prefill, serve and train steps and the tiny hybrid's prefill and serve
steps (disaggregated LoRA, 8 adapters; the train step at a batch of 4 in 2
microbatches, one sequence per data shard: the 1x1 step in
``accum_for``'s 16 is held to the reference in
``tests/test_torch_steps.py``), on weights, caches and batches drawn with
numpy from a seed.  Each process writes the gathered outputs
(``full_tensor()``) of every step; they are held against the reference's
jitted steps on its ``make_local_mesh()`` and against the port's 1x1 run:
argmax ids equal, caches within 1e-5, the loss and every trained
parameter within ``tests/test_torch_training.py``'s tolerances.  The same
processes run each resharding rule of ``steps._Reshard`` and each layout
of ``core/shards.lookup`` on small tensors, held to the plain operation.
The four processes are spawned once for the module, meet through a
``file://`` rendezvous with a 60 s timeout on every collective, and are
killed past a deadline while the parent computes both references.  JAX is
imported in the parent only, inside the reference's fixture, so the
spawned processes do not load it.  The collectives the steps issue are
counted in ``tests/test_torch_collectives.py``.
"""
import dataclasses
import faulthandler
import os
import time
from datetime import timedelta
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import bridge
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.core import shards
from repro_torch.core.config import LoRAConfig, ModelConfig, ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import base
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as topt

TOL = dict(rtol=1e-4, atol=1e-5)         # tests/test_torch_training.py's
CACHE_TOL = dict(rtol=0, atol=1e-5)
B, S = 2, 24                             # prefill and serve
TB, TS, ACCUM = 4, 16, 2                 # train: 2 microbatches of 2
WORLD, GRID = 4, (2, 2)
PG_TIMEOUT = timedelta(seconds=60)       # every collective of the group
JOIN_S = 150                             # the four processes' deadline
STACK_S = 240                            # a hang prints every stack


def dense_cfg():
    return ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256, dtype="float32",
                       lora=LoRAConfig(rank=8), remat=True)


CFGS = {"dense": dense_cfg(), "hybrid": trg.tiny()}
CASES = [("dense", "prefill"), ("dense", "decode"), ("dense", "train"),
         ("hybrid", "prefill"), ("hybrid", "decode")]
IDS = [f"{fam}-{mode}" for fam, mode in CASES]
# each rule of steps._Reshard and each layout of shards.lookup
RULES = ["lookup-fsdp", "lookup-rows", "lookup-vocab",
         "index-ids-over-both-dims", "flip", "partial-plus-sharded"]


@pytest.fixture(autouse=True, scope="module")
def _stacks_on_hang():
    """A test of this module that hangs prints every thread's stack."""
    faulthandler.dump_traceback_later(STACK_S, exit=False)
    yield
    faulthandler.cancel_dump_traceback_later()


def _draw(tree, rng, scale):
    """Tensors shaped as the meta tensors of ``tree``, floats drawn
    normal(0, scale) with numpy, integers zero."""
    def leaf(t):
        if not t.is_floating_point():
            return torch.zeros(t.shape, dtype=t.dtype)
        a = rng.standard_normal(tuple(t.shape)) * scale
        return torch.from_numpy(a.astype(np.float32)).to(t.dtype)
    return base.tree_map(leaf, tree)


def shape_of(mode):
    return ShapeConfig("t", TS, TB, "train") if mode == "train" else \
        ShapeConfig(mode, S, B, mode)


def inputs(fam, mode):
    """The arguments of one built step, the same in every process."""
    cfg = CFGS[fam]
    api = get_model(cfg)
    rng = np.random.default_rng(7 + CASES.index((fam, mode)))
    params = _draw(api.init_params(0, device="meta"), rng, 0.05)
    if mode == "train":
        opt = topt.get_optimizer(cfg.optimizer)[0](params)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TB, TS), dtype=np.int32))
            for k in ("tokens", "labels")}
        return params, opt, batch
    lora = _draw(api.init_lora_stacks(0, steps.N_ADAPTERS, device="meta"),
                 rng, 0.05)
    ids = torch.tensor([3, 6], dtype=torch.int32)
    if mode == "prefill":
        tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        return params, lora, {"tokens": torch.from_numpy(tokens)}, ids
    cache = _draw(api.init_cache(B, S, disagg=True, device="meta"), rng,
                  1.0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,),
                                        dtype=np.int32))
    kv_len = torch.tensor([S - 7, S - 1], dtype=torch.int32)
    return params, lora, cache, tok, kv_len, ids


def built_step(fam, mode, mesh):
    return steps.build_step(CFGS[fam], mesh, shape_of(mode), disagg=True,
                            accum=ACCUM)


def flat(tree, prefix=""):
    """{path: numpy array} of a tree of tensors or arrays (DTensors
    gathered whole)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in flat(x, f"{prefix}/{i}").items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return {prefix: bridge.tensor_to_numpy(tree)}
    return {prefix: np.asarray(tree)}


def _rules(mesh):
    """{case: (sharded, plain)} numpy results of each resharding rule and
    each lookup layout on inputs drawn with numpy (the same in every
    process); a lookup's rows and the table's gradient under a drawn
    cotangent."""
    rng = np.random.default_rng(11)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    def lay(t, *pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    def both(got, want):
        return bridge.tensor_to_numpy(got.full_tensor()), \
            bridge.tensor_to_numpy(want)

    out = {}
    table, ids, cot = draw(16, 8), torch.from_numpy(
        rng.integers(0, 16, (4, 3))), draw(4, 3, 8)
    plain = table.clone().requires_grad_()
    (plain[ids] * cot).sum().backward()
    for name, pl in (("lookup-fsdp", (Shard(1), Shard(0))),
                     ("lookup-rows", (Shard(0), Replicate())),
                     ("lookup-vocab", (Replicate(), Shard(0)))):
        w = lay(table, *pl).requires_grad_()
        with steps.sharded():
            rows = shards.lookup(w, lay(ids, Shard(0), Replicate()))
            (rows * cot).sum().backward()
        out[name] = both(rows, table[ids])
        out[name + "-grad"] = both(w.grad, plain.grad)
    flat_ids = ids.reshape(-1)[:8]
    with steps.sharded():
        out["index-ids-over-both-dims"] = both(
            lay(table, Replicate(), Replicate())[
                lay(flat_ids, Shard(0), Shard(0))], table[flat_ids])
        x = draw(4, 6)
        out["flip"] = both(lay(x, Shard(0), Shard(1)).flip([1]),
                           x.flip([1]))
        a, b, bias = draw(4, 8), draw(8, 6), draw(6)
        out["partial-plus-sharded"] = both(
            lay(a, Replicate(), Shard(1)) @ lay(b, Replicate(), Shard(0))
            + lay(bias, Replicate(), Shard(0)), a @ b + bias)
    return out


def _worker(rank, tmp):
    """One of the four processes: every case's step on the 2x2 mesh, then
    the rules; rank 0 writes the gathered outputs."""
    faulthandler.dump_traceback_later(STACK_S, exit=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD, timeout=PG_TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", GRID,
                                mesh_dim_names=("data", "model"))
        for fam, mode in CASES:
            built = built_step(fam, mode, mesh)
            out = steps.run_sharded(built, mesh, *steps.shard_args(
                built, mesh, inputs(fam, mode)))
            got = flat(out)
            if rank == 0:
                np.savez(os.path.join(tmp, f"{fam}-{mode}.npz"), **got)
        rules = _rules(mesh)
        if rank == 0:
            np.savez(os.path.join(tmp, "rules.npz"), **{
                f"{name}/{i}": a for name, pair in rules.items()
                for i, a in enumerate(pair)})
    finally:
        dist.destroy_process_group()


def _jax_reference():
    """The reference's jitted steps on its ``make_local_mesh()``, on the
    same inputs: {case: flat outputs}."""
    import jax
    import jax.numpy as jnp
    from repro.configs import recurrentgemma_9b as jrg
    from repro.core.config import LoRAConfig as JLoRAConfig
    from repro.core.config import ModelConfig as JModelConfig
    from repro.core.config import ShapeConfig as JShapeConfig
    from repro.launch import mesh as jmesh
    from repro.launch import steps as jsteps
    from repro.training import train_loop as jtl

    fields = dataclasses.asdict(dense_cfg())
    fields["lora"] = JLoRAConfig(**fields["lora"])
    jcfgs = {"dense": JModelConfig(**fields), "hybrid": jrg.tiny()}

    def jx(tree):
        """A port tree as fresh JAX arrays (each call: new buffers, which
        a step may donate)."""
        return base.tree_map(lambda t: jnp.asarray(
            bridge.tensor_to_numpy(t)) if isinstance(t, torch.Tensor)
            else t, tree)

    mesh = jmesh.make_local_mesh()
    out = {}
    # the port's train step takes ACCUM microbatches; the reference's its
    # accum_for's, looked up by the config's name
    with mock.patch.dict(jsteps.ACCUM_STEPS,
                         {jcfgs["dense"].name: ACCUM}):
        for fam, mode in CASES:
            jcfg, args = jcfgs[fam], inputs(fam, mode)
            shape = JShapeConfig("t", *((TS, TB) if mode == "train" else
                                        (S, B)), mode)
            if mode == "train":
                built = jsteps.build_train_step(jcfg, mesh, shape)
                jinit, _ = jtl.make_train_step(jcfg, accum_steps=ACCUM)
                params, _, batch = args
                # the step donates its params and state: no buffer in both
                state = jax.tree_util.tree_map(
                    lambda a: jnp.array(a, copy=True), jinit(jx(params)))
                with mesh:
                    res = built.step_fn(jx(params), state, jx(batch))
            else:
                build = jsteps.build_prefill_step if mode == "prefill" else \
                    jsteps.build_serve_step
                built = build(jcfg, mesh, shape, disagg=True)
                with mesh:
                    res = built.step_fn(*(jx(a) for a in args))
            out[(fam, mode)] = flat(jax.tree_util.tree_map(np.asarray, res))
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{case: (2x2 outputs, 1x1 outputs, the reference's outputs)}: the
    four processes run while the parent computes both references."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    ctx = tmp_mp.start_processes(_worker, args=(tmp,), nprocs=WORLD,
                                 join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {}
        for fam, mode in CASES:
            built = built_step(fam, mode, {"data": 1, "model": 1})
            one[(fam, mode)] = flat(built.step_fn(*inputs(fam, mode)))
        ref = _jax_reference()
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the processes ran past {JOIN_S} s")
    finally:
        torch.set_num_threads(threads)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    got = {case: (dict(np.load(os.path.join(tmp, f"{case[0]}-{case[1]}"
                                                 ".npz"))),
                  one[case], ref[case]) for case in CASES}
    rules = np.load(os.path.join(tmp, "rules.npz"))
    names = {k.rsplit("/", 1)[0] for k in rules.files}
    got["rules"] = {n: (rules[n + "/0"], rules[n + "/1"]) for n in names}
    return got


def _hold(got, want, mode):
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        g, w = got[key], want[key]
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            tol = TOL if mode == "train" else CACHE_TOL
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), **tol,
                                       err_msg=key)


def _trained(outputs):
    """A train step's new parameters and loss (the optimizer state's
    layout is the port's own)."""
    return {k: v for k, v in outputs.items()
            if k.startswith("/0/") or k == "/2/loss"}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_jax(sharded, case):
    """2x2 against the reference: ids equal, caches within 1e-5; the loss
    and every parameter after one train step within 1e-4/1e-5."""
    got, _, want = sharded[case]
    if case[1] == "train":
        got, want = _trained(got), _trained(want)
    _hold(got, want, case[1])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_1x1(sharded, case):
    """2x2 against the port's own 1x1 run of the same built step, every
    output (the optimizer state too)."""
    got, one, _ = sharded[case]
    _hold(got, one, case[1])


@pytest.mark.parametrize("name", RULES + [r + "-grad" for r in RULES
                                          if r.startswith("lookup")])
def test_reshard_rule_matches_the_plain_op(sharded, name):
    """Each rule of ``steps._Reshard`` (ids sharded over both mesh dims, a
    ``flip`` of a sharded dim, a partial sum plus a sharded bias) and each
    layout of ``shards.lookup`` (the table sharded on d as FSDP shards it,
    on its rows over the ids' mesh dim, on its rows over the other), on the
    2x2 mesh, against the plain operation: the rows, the index and the
    flip bit for bit; the product and the lookups' gradients, which sum in
    another order (a repeated id's rows over the ids' shards), within
    1e-5."""
    got, want = sharded["rules"][name]
    if name == "partial-plus-sharded" or name.endswith("-grad"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
