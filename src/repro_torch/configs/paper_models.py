"""The paper's own evaluation models (ForkKV §7.1): Llama3-8B, Qwen2.5-7B,
Qwen2.5-14B — used by the benchmark suite, not part of the assigned pool."""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

LLAMA3_8B = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    lora=LoRAConfig(rank=16), scan_layers=True, citation="arXiv:2407.21783")

QWEN25_7B = ModelConfig(
    name="qwen2.5-7b", family="dense", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    lora=LoRAConfig(rank=16), scan_layers=True, citation="Qwen2.5")

QWEN25_14B = ModelConfig(
    name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=13824, vocab_size=152064,
    lora=LoRAConfig(rank=16), scan_layers=True, citation="Qwen2.5")


def tiny_serving_model(rank: int = 16, *, sliding_window: int = 0,
                       num_heads: int = 8, num_kv_heads: int = 4,
                       num_layers: int = 4, d_model: int = 256,
                       vocab_size: int = 1024) -> ModelConfig:
    """Small llama-family model for the CPU serving engine / benchmarks.

    The attention-flavour knobs (MHA/GQA/MQA via head counts, SWA via
    ``sliding_window``) exist for the cross-mode parity matrix
    (tests/test_parity_matrix.py); the defaults are the historical
    serve-tiny shape."""
    return ModelConfig(
        name="serve-tiny", family="dense", num_layers=num_layers,
        d_model=d_model, num_heads=num_heads, num_kv_heads=num_kv_heads,
        d_ff=2 * d_model, vocab_size=vocab_size, dtype="float32",
        sliding_window=sliding_window, lora=LoRAConfig(rank=rank),
        scan_layers=True, remat=False)
