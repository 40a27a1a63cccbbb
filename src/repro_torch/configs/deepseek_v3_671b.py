"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
v 128), 1 shared + 256 routed experts top-8, MTP aux head.
[arXiv:2412.19437]

Layer program: 3 dense-FFN prefix layers (d_ff 18432) then 58 MoE
layers. MLA decode uses the absorbed-latent form (cache = 576/token).
Router: softmax + Switch aux loss stands in for the paper's
aux-loss-free sigmoid+bias scheme (DESIGN.md adaptation table).
"""

from repro_torch.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: per-head latent expansion, no GQA grouping
    d_ff=18432,  # dense prefix layers
    vocab_size=129280,
    norm="rmsnorm",
    act="silu",
    rope_theta=1e4,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    use_mtp=True,
    prefix_pattern=(LayerSpec(ffn="dense"),) * 3,
    base_pattern=(LayerSpec(ffn="moe"),),
    base_groups=29,
    mod_pattern=(LayerSpec(ffn="moe"),),
    mod_groups=29,
    d_fusion=4096,
    param_dtype="bfloat16",
)
