"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H d_ff=8192
vocab=256206, enc-dec, multimodal. [arXiv:2308.11596]

Backbone only, per the carve-out: the mel-spectrogram + conformer
feature frontend is stubbed — input_specs provides precomputed frame
embeddings (B, S_enc, d_model) feeding a 24L bidirectional encoder
(w2v-BERT 2.0 depth); the 24L decoder consumes them via cross-attention.
IFL privacy constraint: cross-attention only below the fusion cut
(modular block is pure self-attention), see DESIGN.md.
"""

from repro_torch.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596 (hf:facebook/seamless-m4t-v2-large)",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm="layernorm",
    act="gelu",
    is_encdec=True,
    enc_layers=24,
    enc_seq_len=1024,  # default stub frame budget (overridden per shape)
    base_pattern=(LayerSpec(cross_attn=True),),
    base_groups=12,
    mod_pattern=(LayerSpec(),),
    mod_groups=12,
    d_fusion=1024,
)
