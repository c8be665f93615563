"""The port's built steps (``launch/steps.py``) on a 1x1 CPU mesh against
the reference's jitted steps on its ``make_local_mesh()``, and the dry run
(``launch/dryrun.py``).

The prefill step (a fresh cache, the prompt, the last position's argmax)
and the serve step (one token against a cache) of a tiny f32 dense model
and of a tiny hybrid, with disaggregated LoRA, from the reference's weights
carried across by ``repro_torch.bridge``: argmax ids equal, caches within
1e-5.  The train step of the tiny dense model with ``accum_for``'s 16
microbatches: loss and every parameter after one step within the
tolerances of ``tests/test_torch_training.py``.  ``dryrun.main`` on one
applicable pair and one that does not apply writes its JSON, and exits 0.
Each reference result is computed once per module.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import recurrentgemma_9b as jrg
from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.core.config import ShapeConfig as JShapeConfig
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models.registry import get_model as jget_model
from repro.training import train_loop as jtl
from repro_torch import bridge
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.core.config import LoRAConfig, ModelConfig, ShapeConfig
from repro_torch.launch import dryrun, mesh as tmesh, steps
from repro_torch.launch import sharding as shd
from repro_torch.training import optimizer as topt
from repro_torch.models import base as tbase

TOL = dict(rtol=1e-4, atol=1e-5)         # tests/test_torch_training.py's
CACHE_TOL = dict(rtol=0, atol=1e-5)
CPU = "cpu"
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def local_mesh():
    """The port's 1x1 mesh on the CPU (a one-rank group, torn down after
    the test, so no other test finds it up)."""
    mesh = tmesh.make_local_mesh(CPU)
    yield mesh
    dist.destroy_process_group()


def dense_cfg():
    return ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256, dtype="float32",
                       lora=LoRAConfig(rank=8), remat=True)


def _jcfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields["lora"] = JLoRAConfig(**fields["lora"])
    return JModelConfig(**fields)


CFGS = {"dense": (dense_cfg(), _jcfg(dense_cfg())),
        "hybrid": (trg.tiny(), jrg.tiny())}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    """Every leaf of the reference's tree ``want`` against the port's."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tbase.leaves(got))
    for path, w in flat:
        g = got
        for p in path:
            g = g[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's prefill and serve steps for each tiny config (8
    adapters, disaggregated), and its train step of the dense one, each
    jitted on ``make_local_mesh()``, with their inputs."""
    rng = np.random.default_rng(0)
    mesh = jmesh.make_local_mesh()
    out = {}
    for fam, (_, jcfg) in CFGS.items():
        api = jget_model(jcfg)
        params = api.init_params(jax.random.PRNGKey(0))
        lora = api.init_lora_stacks(jax.random.PRNGKey(1),
                                    n=jsteps.N_ADAPTERS)
        tokens = rng.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
        ids = np.array([3, 6], np.int32)
        shape = JShapeConfig("p", S, B, "prefill")
        built = jsteps.build_prefill_step(jcfg, mesh, shape, disagg=True)
        with mesh:
            pid, pcache = built.step_fn(params, lora,
                                        {"tokens": jnp.asarray(tokens)},
                                        jnp.asarray(ids))
        tok = rng.integers(0, jcfg.vocab_size, (B,), dtype=np.int32)
        kv_len = np.array([S - 7, S - 1], np.int32)
        shape = JShapeConfig("d", S, B, "decode")
        built = jsteps.build_serve_step(jcfg, mesh, shape, disagg=True)
        cache_in = _np(pcache)
        with mesh:
            sid, scache = built.step_fn(
                params, lora, jax.tree_util.tree_map(jnp.asarray, cache_in),
                jnp.asarray(tok), jnp.asarray(kv_len), jnp.asarray(ids))
        out[fam] = dict(params=_np(params), lora=_np(lora), tokens=tokens,
                        ids=ids, tok=tok, kv_len=kv_len,
                        prefill=(np.asarray(pid), _np(pcache)),
                        cache_in=cache_in,
                        serve=(np.asarray(sid), _np(scache)))
    jcfg = CFGS["dense"][1]
    api = jget_model(jcfg)
    params = api.init_params(jax.random.PRNGKey(0))
    batch = {k: rng.integers(0, jcfg.vocab_size, (16, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    shape = JShapeConfig("t", 16, 16, "train")
    built = jsteps.build_train_step(jcfg, mesh, shape)
    jinit, _ = jtl.make_train_step(jcfg,
                                   accum_steps=jsteps.accum_for(jcfg))
    # the step donates its params and state: hand it copies of its own
    start = _np(params)
    copy = functools.partial(jax.tree_util.tree_map,
                             lambda a: jnp.array(a, copy=True))
    with mesh:
        new, _, m = built.step_fn(
            copy(params), copy(jinit(params)),
            {k: jnp.asarray(v) for k, v in batch.items()})
    out["train"] = dict(params=start, batch=batch, new=_np(new),
                        loss=float(m["loss"]),
                        grad_norm=float(m["grad_norm"]))
    return out


def _torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: bridge.tensor_from_numpy(np.asarray(a), CPU), tree)


@pytest.mark.parametrize("fam", list(CFGS))
def test_prefill_step_matches_jax(jax_steps, local_mesh, fam):
    cfg, _ = CFGS[fam]
    want = jax_steps[fam]
    built = steps.build_prefill_step(cfg, local_mesh,
                                     ShapeConfig("p", S, B, "prefill"),
                                     disagg=True)
    ids, cache = built.step_fn(
        bridge.params_from_jax(want["params"], CPU),
        bridge.lora_from_jax(want["lora"], CPU),
        {"tokens": torch.from_numpy(want["tokens"])},
        torch.from_numpy(want["ids"]))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want["prefill"][0])
    _close(cache, want["prefill"][1], CACHE_TOL)


@pytest.mark.parametrize("fam", list(CFGS))
def test_serve_step_matches_jax(jax_steps, local_mesh, fam):
    cfg, _ = CFGS[fam]
    want = jax_steps[fam]
    built = steps.build_serve_step(cfg, local_mesh,
                                   ShapeConfig("d", S, B, "decode"),
                                   disagg=True)
    ids, cache = built.step_fn(
        bridge.params_from_jax(want["params"], CPU),
        bridge.lora_from_jax(want["lora"], CPU),
        _torch_tree(want["cache_in"]), torch.from_numpy(want["tok"]),
        torch.from_numpy(want["kv_len"]), torch.from_numpy(want["ids"]))
    np.testing.assert_array_equal(ids.numpy(), want["serve"][0])
    _close(cache, want["serve"][1], CACHE_TOL)


def test_train_step_matches_jax(jax_steps, local_mesh):
    """``accum_for``'s 16 microbatches of one sequence each, AdamW."""
    cfg, _ = CFGS["dense"]
    want = jax_steps["train"]
    built = steps.build_train_step(cfg, local_mesh,
                                   ShapeConfig("t", 16, 16, "train"))
    assert built.description == "train_step accum=16 opt=adamw"
    params = bridge.params_from_jax(want["params"], CPU)
    opt = topt.get_optimizer(cfg.optimizer)[0](params)
    new, opt, m = built.step_fn(params, opt, want["batch"])
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                  rel=1e-4)
    _close(new, want["new"], TOL)


def test_built_steps_carry_abstract_state_and_shardings(local_mesh):
    """On the 1x1 mesh every leaf is whole: its spec empty, its
    placements replicated; the abstract arguments hold no memory."""
    cfg, _ = CFGS["hybrid"]
    built = steps.build_serve_step(cfg, local_mesh,
                                   ShapeConfig("d", S, B, "decode"))
    assert built.description.startswith("serve_step disagg=True")
    for arg in built.abstract_args:
        for t in tbase.leaves(arg):
            assert t.device.type == "meta"
    specs = []
    shd.map_leaves(lambda t, s: specs.append(s), built.abstract_args[0],
                   built.shardings.args[0])
    assert specs and all(s.spec == () for s in specs)


def test_dryrun_main_writes_its_records(tmp_path):
    """One applicable pair (ok) and one whose shape does not apply
    (skipped), on the single-pod mesh over the fake backend."""
    out = tmp_path / "dryrun.json"
    rc = dryrun.main(["--arch", "internlm2-1.8b", "--shape",
                      "decode_32k,long_500k", "--mesh", "single", "--out",
                      str(out)])
    assert rc == 0
    assert not dist.is_initialized()
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    ok = recs[0]
    assert ok["chips"] == 256 and ok["mesh"] == "single"
    for k in ("description", "flops", "memory", "analytic",
              "useful_fraction"):
        assert k in ok
    assert ok["analytic"]["terms"]["dominant"] in (
        "compute_s", "memory_s", "collective_s")
    assert ok["memory"]["argument_size_in_bytes"] > 0
    assert ok["flops"] > 0
