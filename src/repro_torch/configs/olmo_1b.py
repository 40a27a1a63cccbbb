"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192
vocab=50304, non-parametric LayerNorm. [arXiv:2402.00838]"""

from repro_torch.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    tie_embeddings=True,
    norm="nonparam_ln",  # OLMo's distinguishing choice
    act="silu",
    rope_theta=1e4,
    base_pattern=(LayerSpec(),),
    base_groups=8,
    mod_pattern=(LayerSpec(),),
    mod_groups=8,
    d_fusion=2048,
)
