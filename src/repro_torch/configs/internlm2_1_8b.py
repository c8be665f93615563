"""internlm2-1.8b [dense]: GQA kv=8.
(port of ``repro/configs/internlm2_1_8b.py``, field for field).
[arXiv:2403.17297]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92544,
    lora=LoRAConfig(rank=16), scan_layers=True,
    citation="arXiv:2403.17297")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internlm2-tiny", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        dtype="float32", remat=False)
