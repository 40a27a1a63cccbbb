"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + 1 shared, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family card]

Layer program (period 4): iRoPE-style 3 chunked-local(8192) : 1
NoPE-global attention, with MoE FFN on every other layer (Maverick's
interleaved dense/MoE). Chunked attention is realized as sliding-window
8192 (TPU adaptation note in DESIGN.md); local layers' bounded caches
qualify this arch for long_500k.
"""

from repro_torch.config import LayerSpec, ModelConfig

_PAT = (
    LayerSpec(window=8192, ffn="dense"),
    LayerSpec(window=8192, ffn="moe"),
    LayerSpec(window=8192, ffn="dense"),
    LayerSpec(use_rope=False, ffn="moe"),  # NoPE global layer
)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Maverick-17B-128E (card: Scout-17B-16E)",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    norm="rmsnorm",
    act="silu",
    rope_theta=5e5,
    use_qk_norm=True,
    num_experts=128,
    num_experts_per_tok=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    base_pattern=_PAT,
    base_groups=6,
    mod_pattern=_PAT,
    mod_groups=6,
    d_fusion=4096,
    param_dtype="bfloat16",
)
