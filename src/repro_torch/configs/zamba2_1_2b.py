"""zamba2-1.2b [hybrid]: 38L d_model=2048 (Mamba2, ssm_state=64) with a
SHARED attention(32H, kv=32)+MLP block every 6 layers, d_ff=8192
vocab=32000. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        norm="rmsnorm", activation="gelu",
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_period=6)
