"""llava-next-mistral-7b [vlm]: mistral-7B language backbone, anyres vision
tiling (frontend stubbed to patch embeddings).
(port of ``repro/configs/llava_next_mistral_7b.py``, field for field).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    frontend="vision_stub", num_patches=2880,   # anyres: base + 4 tiles x 576
    lora=LoRAConfig(rank=16), scan_layers=True,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, num_patches=8,
        dtype="float32", remat=False)
