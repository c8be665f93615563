"""The port's training substrate (``repro_torch.training``) against the
JAX package's: ports of each test of ``tests/test_training_substrate.py``
on the port, and parity with the reference.

Parity: one step of ``make_train_step`` from the reference's weights
(bridged) on the same batch, with AdamW, with Adafactor, with
``accum_steps`` 2 (held to the reference's accum-2 step and to the port's
accum-1 step), and one step of ``make_lora_train_step``: loss,
``grad_norm`` and every updated leaf, f32, rtol 1e-4 / atol 1e-5 (sums in
another order; an AdamW step of lr 1e-3 normalises each gradient, so a
leaf whose gradient is near zero moves by up to ~3e-6 apart).  The data
stream is held bit for bit to the reference's for several (seed, step,
shard, task_id); a checkpoint the JAX package wrote (bf16 leaves
included) restores into the port's tree equal to the bridge's output, and
one the port wrote restores into the reference's.  Without a card, the
steps and the launcher raise unless asked for the CPU.  Each JAX result is
computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import LoRAConfig as JLoRAConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.models.registry import get_model as jget_model
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import train_loop as jtl
from repro_torch import bridge
from repro_torch.core.config import LoRAConfig, ModelConfig
from repro_torch.launch import train as tlaunch
from repro_torch.models import base as tbase
from repro_torch.models.registry import get_model
from repro_torch.training import checkpoint, data, train_loop
from repro_torch.training import optimizer as topt

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_cfg(**kw):
    """test_training_substrate.py's ``tiny_cfg``, for the port."""
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                dtype="float32", lora=LoRAConfig(rank=8), remat=True)
    base.update(kw)
    return ModelConfig(**base)


def jtiny_cfg(**kw):
    cfg = tiny_cfg(**kw)
    fields = dataclasses.asdict(cfg)
    fields["lora"] = JLoRAConfig(**fields["lora"])
    return JModelConfig(**fields)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for p in path:
        tree = tree[getattr(p, "key", getattr(p, "idx", None))]
    return tree


def _close_trees(got, want):
    """Every leaf of the reference's tree ``want`` against the port's."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tbase.leaves(got))
    for path, w in flat:
        np.testing.assert_allclose(_leaf(got, path).numpy(), np.asarray(w),
                                   **TOL, err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------ the substrate's tests
def _run_steps(cfg, n=25, accum=1):
    init, step = train_loop.make_train_step(cfg, lr=1e-3, accum_steps=accum,
                                            device=CPU)
    params = get_model(cfg).init_params(0, device=CPU)
    opt = init(params)
    losses = []
    for _, b in zip(range(n), data.make_stream(cfg.vocab_size, 32, 8)):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses, params


def test_adamw_loss_decreases():
    losses, _ = _run_steps(tiny_cfg())
    assert losses[-1] < losses[0]


def test_adafactor_loss_decreases():
    losses, _ = _run_steps(tiny_cfg(optimizer="adafactor"))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_grad_accumulation_matches_full_batch():
    """accum=2 over batch 8 must equal accum=1 with the same data/params
    (the same step function reused: the arguments are left as they
    are)."""
    cfg = tiny_cfg(remat=False)
    params = get_model(cfg).init_params(0, device=CPU)
    batch = next(iter(data.make_stream(cfg.vocab_size, 32, 8)))
    outs = []
    for accum in (1, 2):
        init, step = train_loop.make_train_step(cfg, lr=1e-3,
                                                accum_steps=accum,
                                                device=CPU)
        p2, _, m = step(params, init(params), batch)
        outs.append((float(m["loss"]), tbase.leaves(p2)[0].numpy()))
    assert abs(outs[0][0] - outs[1][0]) < 1e-5
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-5)


def test_lora_finetune_trains_only_adapters():
    cfg = tiny_cfg()
    api = get_model(cfg)
    params = api.init_params(0, device=CPU)
    lora = api.init_lora_stacks(1, 2, device=CPU)
    init, step = train_loop.make_lora_train_step(cfg, lr=5e-3, adapter_id=1,
                                                 device=CPU)
    opt = init(lora)
    before = [t.clone() for t in tbase.leaves(params)]
    losses = []
    for _, b in zip(range(15), data.make_stream(cfg.vocab_size, 32, 8,
                                                task_id=3)):
        lora, opt, m = step(lora, opt, params, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for a, b in zip(before, tbase.leaves(params)):
        assert torch.equal(a, b)
        assert not b.requires_grad


def test_data_pipeline_deterministic_and_sharded():
    full = data.make_stream(256, 16, 8, seed=7)
    b_full = next(iter(full))
    shards = [next(iter(data.make_stream(256, 16, 8, seed=7, shard_index=i,
                                         num_shards=4)))
              for i in range(4)]
    assert all(s["tokens"].shape == (2, 16) for s in shards)
    again = next(iter(data.make_stream(256, 16, 8, seed=7)))
    np.testing.assert_array_equal(b_full["tokens"], again["tokens"])
    with pytest.raises(ValueError, match="shards"):
        data.make_stream(256, 16, 8, num_shards=3)


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_cfg()
    params = get_model(cfg).init_params(0, device=CPU)
    checkpoint.save(params, str(tmp_path), "m")
    assert checkpoint.exists(str(tmp_path), "m")
    restored = checkpoint.restore(params, str(tmp_path), "m")
    for a, b in zip(tbase.leaves(params), tbase.leaves(restored)):
        assert torch.equal(a, b)


# ------------------------------------------------- parity with the JAX
@pytest.fixture(scope="module")
def jax_steps():
    """The reference's one-step results on ``tiny_cfg``'s weights and the
    stream's first batch: AdamW, Adafactor, AdamW with accum 2, and the
    LoRA step (adapter 1)."""
    out = {}
    batch = next(iter(jdata.make_stream(256, 32, 8)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for label, kw, accum in (("adamw", {}, 1),
                             ("adafactor", dict(optimizer="adafactor"), 1),
                             ("accum", dict(remat=False), 2)):
        cfg = jtiny_cfg(**kw)
        params = jget_model(cfg).init_params(jax.random.PRNGKey(0))
        init, step = jtl.make_train_step(cfg, lr=1e-3, accum_steps=accum)
        p2, _, m = jax.jit(step)(params, init(params), jb)
        out[label] = dict(params=_np(params), new=_np(p2), kw=kw,
                          accum=accum, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]))
    cfg = jtiny_cfg()
    api = jget_model(cfg)
    params = api.init_params(jax.random.PRNGKey(0))
    lora = api.init_lora_stacks(jax.random.PRNGKey(1), 2)
    init, step = jtl.make_lora_train_step(cfg, lr=5e-3, adapter_id=1)
    lora2, _, m = jax.jit(step)(lora, init(lora), params, jb)
    out["lora"] = dict(params=_np(params), lora=_np(lora), new=_np(lora2),
                       loss=float(m["loss"]))
    out["batch"] = batch
    return out


@pytest.mark.parametrize("label", ["adamw", "adafactor", "accum"])
def test_train_step_matches_jax(jax_steps, label):
    """One full-parameter step from the reference's weights: loss,
    grad_norm and every updated parameter."""
    want = jax_steps[label]
    cfg = tiny_cfg(**want["kw"])
    params = bridge.params_from_jax(want["params"], CPU)
    init, step = train_loop.make_train_step(cfg, lr=1e-3,
                                            accum_steps=want["accum"],
                                            device=CPU)
    new, opt, m = step(params, init(params), jax_steps["batch"])
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                  rel=1e-4)
    assert int(opt.step) == 1
    _close_trees(new, want["new"])


def test_accum_2_step_matches_the_ports_accum_1(jax_steps):
    """Accumulating f32 gradients over 2 micro-batches gives the port's
    accum-1 step (and, above, the reference's accum-2 step)."""
    want = jax_steps["accum"]
    cfg = tiny_cfg(**want["kw"])
    params = bridge.params_from_jax(want["params"], CPU)
    outs = []
    for accum in (1, 2):
        init, step = train_loop.make_train_step(cfg, lr=1e-3,
                                                accum_steps=accum,
                                                device=CPU)
        outs.append(step(params, init(params), jax_steps["batch"]))
    assert float(outs[0][2]["loss"]) == pytest.approx(
        float(outs[1][2]["loss"]), abs=1e-5)
    for a, b in zip(tbase.leaves(outs[0][0]), tbase.leaves(outs[1][0])):
        torch.testing.assert_close(a, b, **TOL)


def test_lora_step_matches_jax(jax_steps):
    """One LoRA step: loss and every adapter leaf (``scaling`` included,
    as ``jax.value_and_grad`` over the stacks trains it too); the base
    weights come back untouched."""
    want = jax_steps["lora"]
    cfg = tiny_cfg()
    params = bridge.params_from_jax(want["params"], CPU)
    lora = bridge.lora_from_jax(want["lora"], CPU)
    init, step = train_loop.make_lora_train_step(cfg, lr=5e-3, adapter_id=1,
                                                 device=CPU)
    new, _, m = step(lora, init(lora), params, jax_steps["batch"])
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    _close_trees(new, want["new"])
    _close_trees(params, want["params"])


def test_eval_loss_matches_the_steps_loss(jax_steps):
    want = jax_steps["adamw"]
    params = bridge.params_from_jax(want["params"], CPU)
    got = train_loop.eval_loss(tiny_cfg(), params, jax_steps["batch"],
                               device=CPU)
    assert float(got) == pytest.approx(want["loss"], rel=1e-5)
    assert not got.requires_grad


@pytest.mark.parametrize("seed,step,shards,task", [
    (0, 0, 1, 0), (7, 3, 4, 0), (3, 11, 2, 5), (1234, 1, 8, 2)])
def test_data_stream_is_the_references(seed, step, shards, task):
    """Every shard's batch at ``step``, bit for bit."""
    for shard in range(shards):
        want = jdata.make_stream(1000, 24, 16, seed=seed, task_id=task,
                                 shard_index=shard,
                                 num_shards=shards)._batch(step)
        got = data.make_stream(1000, 24, 16, seed=seed, task_id=task,
                               shard_index=shard,
                               num_shards=shards)._batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path, dtype):
    """A checkpoint the JAX package wrote (bf16 leaves as 2-byte void)
    restores into the port's tree equal to the bridge's output, bit for
    bit; the port's own save of that tree holds the same keys, dtypes and
    bytes as the reference's file, and in f32 restores into the
    reference's tree equal to its weights (the reference's ``restore``
    cannot read back 2-byte void leaves, its own bf16 files included:
    ``jnp.asarray`` has no cast from them)."""
    jcfg = jtiny_cfg(dtype=dtype)
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    jckpt.save(jparams, str(tmp_path / "jax"), "m")
    like = get_model(tiny_cfg(dtype=dtype)).init_params(1, device=CPU)
    got = checkpoint.restore(like, str(tmp_path / "jax"), "m")
    want = bridge.params_from_jax(_np(jparams), CPU)
    for a, b in zip(tbase.leaves(got), tbase.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    checkpoint.save(got, str(tmp_path / "port"), "m")
    with np.load(str(tmp_path / "jax" / "m.npz")) as jf, \
            np.load(str(tmp_path / "port" / "m.npz")) as tf:
        assert sorted(jf.files) == sorted(tf.files)
        for k in jf.files:
            assert jf[k].dtype.str[1:] == tf[k].dtype.str[1:], k
            assert jf[k].tobytes() == tf[k].tobytes(), k
    if dtype == "float32":
        back = jckpt.restore(jparams, str(tmp_path / "port"), "m")
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_refuses_another_shape(tmp_path):
    cfg = tiny_cfg()
    checkpoint.save(get_model(cfg).init_params(0, device=CPU),
                    str(tmp_path), "m")
    other = get_model(tiny_cfg(d_ff=64)).init_params(0, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(other, str(tmp_path), "m")


def test_optimizer_state_shapes_and_names():
    params = {"w": torch.zeros(3, 4), "b": torch.zeros(4),
              "layers": [{"x": torch.zeros(2, 3, 5)}]}
    init, _ = topt.adafactor()
    st = init(params)
    assert st.inner["w"]["vr"].shape == (3,)
    assert st.inner["w"]["vc"].shape == (4,)
    assert st.inner["b"]["v"].shape == (4,)
    assert st.inner["layers"][0]["x"]["vc"].shape == (2, 5)
    init, _ = topt.adamw()
    st = init(params)
    assert st.inner["m"]["layers"][0]["x"].dtype == torch.float32
    with pytest.raises(ValueError):
        topt.get_optimizer("sgd")


# ------------------------------------------------------- device choice
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_steps_raise_without_a_card_unless_cpu(monkeypatch):
    _no_card(monkeypatch)
    cfg = tiny_cfg()
    for make in (train_loop.make_train_step,
                 train_loop.make_lora_train_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
        make(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.eval_loss(cfg, {}, {})


def test_launcher_trains_on_the_cpu_and_raises_without_a_card(
        monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.launch.train`` with ``--device cpu``
    prints the reference's per-step line and saves; without the flag and
    without a card it raises."""
    tlaunch.main(["--arch", "internlm2-1.8b", "--tiny", "--steps", "3",
                  "--batch", "2", "--seq", "16", "--log-every", "1",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines[:3]] == ["0", "1", "2"]
    assert all(ln.startswith("step ") and "loss=" in ln and "gnorm=" in ln
               and ln.endswith("s/step)") for ln in lines[:3])
    assert lines[3].startswith("saved ")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "internlm2-1.8b", "--tiny", "--steps", "1"])


# ------------------------------------------------- models/base additions
def test_base_losses_norms_and_counts_match_jax():
    """``cross_entropy`` (f32 over the vocabulary, with and without a
    mask), ``layer_norm``, ``activation`` and ``count_params`` against
    ``repro.models.base`` on the same numpy inputs, f32 at rtol 1e-5 /
    atol 1e-6; bf16 logits are upcast before the softmax, as the
    reference's are."""
    from repro.models import base as jbase
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    tl, tlab = torch.tensor(logits), torch.tensor(labels)
    for m in (None, mask):
        want = jbase.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   None if m is None else jnp.asarray(m))
        got = tbase.cross_entropy(tl, tlab,
                                  None if m is None else torch.tensor(m))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    got = tbase.cross_entropy(tl.to(torch.bfloat16), tlab)
    want = jbase.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                               jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tbase.layer_norm(torch.tensor(x), torch.tensor(w),
                         torch.tensor(b)).numpy(),
        np.asarray(jbase.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b))), rtol=1e-5, atol=1e-6)
    for name in ("silu", "gelu"):
        np.testing.assert_allclose(
            tbase.activation(name)(torch.tensor(x)).numpy(),
            np.asarray(jbase.activation(name)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)
    jcfg, cfg = jtiny_cfg(), tiny_cfg()
    assert tbase.count_params(get_model(cfg).init_params(0, device=CPU)) \
        == jbase.count_params(jget_model(jcfg).init_params(
            jax.random.PRNGKey(0)))
