"""dbrx-132b [moe]: 16 experts top-4, fine-grained.
(port of ``repro/configs/dbrx_132b.py``, field for field).
[hf:databricks/dbrx-base]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=10752, vocab_size=100352,
    num_experts=16, num_experts_per_tok=4, moe_d_ff=10752,
    lora=LoRAConfig(rank=16), scan_layers=True, scan_groups=8,
    citation="hf:databricks/dbrx-base")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="dbrx-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, moe_d_ff=256, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, dtype="float32",
        moe_capacity_factor=8.0,
        scan_groups=0, remat=False)
