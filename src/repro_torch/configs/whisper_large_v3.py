"""whisper-large-v3 [audio]: enc-dec transformer backbone; conv/mel frontend
stubbed to frame embeddings. MHA (kv=20 == heads). [arXiv:2212.04356]
(port of ``repro/configs/whisper_large_v3.py``, field for field)."""
import dataclasses
from repro_torch.core.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    use_rope=False, is_encoder_decoder=True, num_encoder_layers=32,
    encoder_seq=1500, frontend="audio_stub", mlp_activation="gelu",
    tie_embeddings=True, lora=LoRAConfig(rank=16), scan_layers=True,
    citation="arXiv:2212.04356")


def tiny() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-tiny", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, num_encoder_layers=2,
        encoder_seq=24, dtype="float32", remat=False)
