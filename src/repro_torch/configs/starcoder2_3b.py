"""starcoder2-3b [dense]: GQA kv=2, RoPE, GELU MLP.
(port of ``repro/configs/starcoder2_3b.py``, field for field).
[arXiv:2402.19173]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", num_layers=30, d_model=3072,
    num_heads=24, num_kv_heads=2, d_ff=12288, vocab_size=49152,
    mlp_activation="gelu", lora=LoRAConfig(rank=16), scan_layers=True,
    citation="arXiv:2402.19173")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-tiny", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        dtype="float32", remat=False)
