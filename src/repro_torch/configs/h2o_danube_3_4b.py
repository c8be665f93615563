"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
(port of ``repro/configs/h2o_danube_3_4b.py``, field for field).
[arXiv:2401.16818]"""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    num_heads=32, num_kv_heads=8, d_ff=10240, vocab_size=32000,
    sliding_window=4096, lora=LoRAConfig(rank=16), scan_layers=True,
    citation="arXiv:2401.16818")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="danube-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, sliding_window=16,
        dtype="float32", remat=False)
