"""llama3-405b [dense]: 126L GQA kv=8, 128k vocab. [arXiv:2407.21783]

Port of ``repro/configs/llama3_405b.py``, field for field: the
reference's training settings (Adafactor, a two-level scan, whose
``scan_groups`` sets the remat unit, ``transformer.remat_unit``) drive the
port's train step as they drive the reference's."""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense", num_layers=126, d_model=16384,
    num_heads=128, num_kv_heads=8, d_ff=53248, vocab_size=128256,
    lora=LoRAConfig(rank=16), scan_layers=True, scan_groups=14,
    optimizer="adafactor", citation="arXiv:2407.21783")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama3-tiny", num_layers=2, d_model=128, num_heads=8,
        num_kv_heads=2, d_ff=256, vocab_size=512, dtype="float32",
        scan_groups=0, optimizer="adamw", remat=False)
