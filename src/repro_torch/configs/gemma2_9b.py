"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention, logit softcaps,
head_dim=256, tied embeddings, post-norms. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
        d_ff=14336, vocab_size=256000, head_dim=256,
        norm="rmsnorm", activation="geglu",
        local_global_period=2, local_window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        post_norm=True, scale_embed=True, tie_embeddings=True)
