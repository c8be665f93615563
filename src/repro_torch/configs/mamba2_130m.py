"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.
ForkKV N/A for this family (DESIGN.md §5). [arXiv:2405.21060]
(port of ``repro/configs/mamba2_130m.py``, field for field)."""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_heads=24, ssm_expand=2,
    lora=LoRAConfig(rank=16), scan_layers=True,
    citation="arXiv:2405.21060")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-tiny", num_layers=2, d_model=128,
        vocab_size=512, ssm_state=16, ssm_heads=4, dtype="float32",
        remat=False)
