"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, pattern 1:2
(port of ``repro/configs/recurrentgemma_9b.py``, field for field).
[arXiv:2402.19427]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, d_ff=12288, vocab_size=256000,
    head_dim=256, block_pattern=("rglru", "rglru", "local"),
    local_window=2048, lru_width=4096, lora=LoRAConfig(rank=16),
    scan_layers=False, citation="arXiv:2402.19427")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-tiny", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        local_window=16, lru_width=128, dtype="float32", remat=False)
