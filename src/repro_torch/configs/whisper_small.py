"""whisper-small [audio] — enc-dec; conv frontend stubbed to frame embeddings.
[arXiv:2212.04356; unverified]

12 encoder + 12 decoder layers, d_model=768, 12 heads (MHA), d_ff=3072,
vocab=51865. The mel/conv frontend is a stub: the caller provides
precomputed frame embeddings [B, 1500, d_model].
"""
from repro_torch.configs.base import EncDecConfig, FrontendConfig, ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-small", family="encdec",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51865, head_dim=64,
        encdec=EncDecConfig(enc_layers=12, num_frames=1500),
        frontend=FrontendConfig(kind="audio_stub", num_embeds=1500),
        rope_theta=10000.0, norm_eps=1e-5,
        source="[arXiv:2212.04356; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-small", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        encdec=EncDecConfig(enc_layers=2, num_frames=16),
        frontend=FrontendConfig(kind="audio_stub", num_embeds=16),
    )


register("whisper-small", full_config, smoke_config)
