"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""

from repro_torch.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,  # recorded; IFL forces untied head (DESIGN.md)
    norm="rmsnorm",
    act="silu",
    rope_theta=1e6,
    base_pattern=(LayerSpec(),),
    base_groups=12,
    mod_pattern=(LayerSpec(),),
    mod_groups=12,
    d_fusion=1024,
)
