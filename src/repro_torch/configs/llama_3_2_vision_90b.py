"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attention image layers every 5th layer. The vision
tower's transformer is still stubbed, but the patchify conv stem is REAL:
a 14x14/s14 conv over 560x560 RGB produces the 40x40 = 1600 image tokens
(models.model.encode), served through the quantized conv projection.
[hf:meta-llama/Llama-3.2-11B-Vision family; unverified]"""
from repro_torch.configs.base import ConvSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        norm="rmsnorm", activation="swiglu", rope_theta=500000.0,
        cross_attn_period=5, num_image_tokens=1600,
        conv_stem=(ConvSpec(kh=14, kw=14, sh=14, sw=14, c_in=3, c_out=8192),),
        frontend_hw=(560, 560))
