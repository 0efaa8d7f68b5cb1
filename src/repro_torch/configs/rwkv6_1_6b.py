"""rwkv6-1.6b "Finch" [ssm]: 24L d_model=2048 (attention-free, data-dependent
decay) d_ff=7168 vocab=65536. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536,
        norm="layernorm", activation="relu")
