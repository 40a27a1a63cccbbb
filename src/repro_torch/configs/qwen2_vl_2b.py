"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE, dynamic resolution. [arXiv:2409.12191]

Vision frontend (ViT + merger) is the permitted stub: input_specs
provides precomputed patch embeddings (B, num_image_tokens, d_model);
the M-RoPE text/image position grid is built by the model. head_dim 128
=> M-RoPE frequency sections (16, 24, 24) over the 64 freq bands.
"""

from repro_torch.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191 (hf:Qwen/Qwen2-VL-2B-Instruct)",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1e6,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    num_image_tokens=256,  # stubbed "dynamic resolution" budget per sample
    base_pattern=(LayerSpec(),),
    base_groups=14,
    mod_pattern=(LayerSpec(),),
    mod_groups=14,
    d_fusion=1536,
)
