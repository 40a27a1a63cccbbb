"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba:attention 7:1 interleave, MoE 16 experts
top-2 every other layer. [arXiv:2403.19887]

Layer program (Jamba period 8): attention at position 3, Mamba
elsewhere; MoE FFN on odd positions (every other layer). Mamba state
decode is O(1), so long_500k runs (the 9 attention layers keep full
caches — linear memory at batch 1).
"""

from repro_torch.config import LayerSpec, ModelConfig


def _layer(i: int) -> LayerSpec:
    mixer = "attn" if i == 3 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(mixer=mixer, ffn=ffn, use_rope=False)  # Jamba: no RoPE


_PAT = tuple(_layer(i) for i in range(8))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887 (hf:ai21labs/AI21-Jamba-1.5-Large)",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    norm="rmsnorm",
    act="silu",
    rope_type="none",
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=24576,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    base_pattern=_PAT,
    base_groups=4,
    mod_pattern=_PAT,
    mod_groups=5,
    d_fusion=4096,
    param_dtype="bfloat16",
)
