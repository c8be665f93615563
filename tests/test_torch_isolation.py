"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback, and
every serving setting of the reference constructs and serves."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.paper_models import tiny_serving_model
from repro_torch.core.config import ServeConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.api import ForkServer
from repro_torch.serving.sampling import SamplingParams

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax_or_repro():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)


def _tiny():
    cfg = tiny_serving_model(rank=8, num_layers=1, d_model=64,
                             vocab_size=64, num_heads=4, num_kv_heads=2)
    return (cfg, tfm.init_params(cfg, 0, device="cpu"),
            tfm.init_lora_stacks(cfg, 1, 2, device="cpu"))


def test_entry_points_refuse_to_run_on_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means cuda")
    cfg, params, lora = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForkServer(cfg, params, lora, ServeConfig(max_pages=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg, 0)


@pytest.mark.parametrize("change", [
    dict(host_tier_bytes=1 << 20),
    dict(disk_tier_bytes=1 << 20),
    dict(persist_dir="tmp"),
    "kv_quant",
])
def test_tier_and_int8_settings_construct_and_serve(change, tmp_path):
    """The settings the port once refused (the host and disk tiers, a
    persist dir, int8 bCache pages) construct and serve on the CPU."""
    cfg, params, lora = _tiny()
    sc = ServeConfig(max_pages=16, max_pages_per_req=8, page_size=8)
    if change == "kv_quant":
        cfg = dataclasses.replace(cfg, kv_quant="int8")
    else:
        change = {k: str(tmp_path) if v == "tmp" else v
                  for k, v in change.items()}
        sc = dataclasses.replace(sc, **change)
    server = ForkServer(cfg, params, lora, sc, device="cpu")
    out = server.generate(1, list(range(20)),
                          SamplingParams(max_new_tokens=3)).result()
    assert out.finish_reason == "length" and len(out.tokens) == 3
    eng = server.engine
    if change == "kv_quant":
        assert eng.executor.pools.kb.dtype == torch.int8
        assert eng.executor.pools.kb_s.dtype == torch.float32
    else:
        assert eng.host_tier is not None and eng.base_pool.is_tiered
        assert (eng.disk_tier is not None) == ("disk_tier_bytes" in change)
