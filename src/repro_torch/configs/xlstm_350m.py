"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks. [arXiv:2405.04517]

Paper-style xLSTM[7:1]-ish interleave approximated at period 4
(3 mLSTM : 1 sLSTM); blocks carry their own up/down projections
(d_ff=0: no separate FFN; sLSTM blocks append the paper's gated FFN
internally). mLSTM trains chunkwise-parallel; both decode O(1), which is
why this arch runs long_500k.
"""

from repro_torch.config import LayerSpec, ModelConfig

_PAT = (
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="slstm", ffn="none"),
)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    rope_type="none",
    ssm_expand=2,
    mlstm_chunk=64,
    base_pattern=_PAT,
    base_groups=3,
    mod_pattern=_PAT,
    mod_groups=3,
    d_fusion=1024,
)
