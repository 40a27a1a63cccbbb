"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local(sliding-window-1024):global, 128k context.
[hf:google/gemma-3-1b-pt family card, 27B scale]

Layer program: 2 local prefix layers + 10 groups of (5 local + 1 global)
= 62. QK-norm per gemma3; sliding-window layers give the sub-quadratic
cache that qualifies this dense arch for long_500k (global layers keep
full caches — linear memory, O(S) decode compute).
"""

from repro_torch.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(window=1024)
_GLOBAL = LayerSpec()
_PAT = (_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-27b-pt (card: google/gemma-3-1b-pt)",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",
    rope_theta=1e6,
    use_qk_norm=True,
    prefix_pattern=(_LOCAL, _LOCAL),
    base_pattern=_PAT,
    base_groups=5,
    mod_pattern=_PAT,
    mod_groups=5,
    d_fusion=4096,
    param_dtype="bfloat16",
)
