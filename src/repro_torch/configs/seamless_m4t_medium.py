"""seamless-m4t-medium [audio]: enc-dec transformer BACKBONE, 12+12L
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206. The speech frontend's
feature-extractor conv stem is REAL: two stride-2 temporal convs over
(frames, 1, 80) fbank features — 4096 frames -> the 1024 encoder positions
(models.model.encode) — served through the quantized conv projection.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ConvSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=256206,
        norm="layernorm", activation="relu",
        encoder_layers=12, encoder_seq_len=1024,
        conv_stem=(
            ConvSpec(kh=3, kw=1, sh=2, sw=1, c_in=80, c_out=1024, ph=1),
            ConvSpec(kh=3, kw=1, sh=2, sw=1, c_in=1024, c_out=1024, ph=1),
        ),
        frontend_hw=(4096, 1))
