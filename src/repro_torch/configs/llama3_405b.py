"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, 128k context. [arXiv:2407.21783]"""

from repro_torch.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    norm="rmsnorm",
    act="silu",
    rope_theta=5e5,
    base_pattern=(LayerSpec(),),
    base_groups=63,
    mod_pattern=(LayerSpec(),),
    mod_groups=63,
    d_fusion=4096,
    param_dtype="bfloat16",  # params+grads only (SGD) to fit 256 chips
)
