"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, early fusion.
(port of ``repro/configs/llama4_maverick_400b_a17b.py``, field for field).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
    vocab_size=202048, num_experts=128, num_experts_per_tok=1,
    moe_d_ff=8192, moe_interleave=2, moe_shared_expert=True,
    lora=LoRAConfig(rank=16), scan_layers=True,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama4-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, moe_d_ff=256, vocab_size=512,
        num_experts=4, num_experts_per_tok=1, dtype="float32",
        moe_capacity_factor=8.0,
        scan_groups=0, remat=False)
