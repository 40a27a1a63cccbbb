"""Model configuration: the port's own copy of ``LayerSpec``,
``ModelConfig`` and the assigned input shapes (``ShapeConfig``,
``INPUT_SHAPES``).

A ModelConfig describes an architecture as a *layer program*: an
optional unstacked ``prefix`` of layers, then ``base_groups`` repetitions
of ``base_pattern`` and ``mod_groups`` repetitions of ``mod_pattern``.
Repeated groups are parameterized with a stacked leading
``(num_groups,)`` dim, and the port runs them as a Python loop over it.

The IFL fusion layer cuts the program at a group boundary: everything
below (embedding, prefix, base groups, fusion in-projection) is the
personalized *base block*; everything above (fusion out-projection,
modular groups, final norm, LM head) is the shared *modular block*.
``d_fusion`` is the standardized interface between the two.

The fields, defaults and rules are those of the JAX package's
``ModelConfig``, field for field, so that a config name resolves to the
same shapes in both packages and a serving artifact written by one
loads in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the network: a sequence mixer plus a channel mixer."""

    mixer: str = "attn"  # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    ffn: str = "dense"  # 'dense' | 'moe' | 'none'
    window: int = -1  # -1 = global causal attention; >0 = sliding window
    use_rope: bool = True  # False => NoPE (llama4 global layers)
    cross_attn: bool = False  # decoder cross-attention (enc-dec only)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (the JAX package's ``ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # citation for the assigned config

    # Transformer core.
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln  (olmo)
    act: str = "silu"  # silu | gelu
    rope_theta: float = 10000.0
    rope_type: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl: (t, h, w) head_dim split

    # Layer program. Empty patterns => uniform ('attn','dense') program
    # split evenly at num_layers//2.
    prefix_pattern: Tuple[LayerSpec, ...] = ()
    base_pattern: Tuple[LayerSpec, ...] = ()
    base_groups: int = 0
    mod_pattern: Tuple[LayerSpec, ...] = ()
    mod_groups: int = 0

    use_qk_norm: bool = False  # gemma3-style per-head q/k RMSNorm

    # MoE.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v3).
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / xLSTM.
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 => ceil(d_model/16)
    mlstm_qk_dim: int = 0  # 0 => d_model // 2
    mlstm_chunk: int = 64

    # Encoder-decoder (seamless).
    is_encdec: bool = False
    enc_layers: int = 0
    enc_seq_len: int = 0

    # Multimodal stub frontends.
    num_image_tokens: int = 0

    # Multi-token prediction aux head (deepseek-v3 optional feature).
    use_mtp: bool = False
    mtp_depth: int = 1

    # IFL fusion interface.
    d_fusion: int = 2048

    # Numerics.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logit_softcap: float = 0.0
    remat: str = "group"  # 'none' | 'group' | 'layer'
    ce_chunk: int = 0

    # Attention blocking (full-sequence attention; unused by decode).
    q_block: int = 512
    kv_block: int = 512

    # ----------------------------------------------------------------- utils

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def _resolved_program(self):
        """(prefix, base_pattern, base_groups, mod_pattern, mod_groups)."""
        if not self.base_pattern and not self.mod_pattern:
            bg = max(1, self.num_layers // 2)
            return (), (LayerSpec(),), bg, (LayerSpec(),), self.num_layers - bg
        return (
            self.prefix_pattern,
            self.base_pattern,
            self.base_groups,
            self.mod_pattern,
            self.mod_groups,
        )

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Full per-layer program: prefix, base groups, modular groups."""
        pre, bp, bg, mp, mg = self._resolved_program()
        return pre + bp * bg + mp * mg

    @property
    def fusion_cut_layer(self) -> int:
        """Index of the first modular layer (= number of base layers)."""
        pre, bp, bg, _, _ = self._resolved_program()
        return len(pre) + len(bp) * bg

    def validate(self) -> "ModelConfig":
        specs = self.layer_specs()
        if len(specs) != self.num_layers:
            raise ValueError(
                f"{self.name}: layer program covers {len(specs)} layers, "
                f"config says {self.num_layers}"
            )
        if any(s.ffn == "moe" for s in specs) and not (
                self.num_experts > 0 and self.num_experts_per_tok > 0):
            raise ValueError(f"{self.name}: moe layers need experts")
        if self.use_mla and not (
                self.kv_lora_rank > 0 and self.qk_rope_head_dim > 0):
            raise ValueError(f"{self.name}: MLA needs kv_lora/rope dims")
        # IFL privacy: cross-attention (needs client-local encoder output)
        # may only appear below the fusion cut.
        _, _, _, mp, _ = self._resolved_program()
        if any(s.cross_attn for s in mp):
            raise ValueError(
                f"{self.name}: cross-attn layers above the fusion cut would "
                "leak encoder activations across the IFL boundary"
            )
        return self

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # A reduced variant of the same family for CPU tests:
    # 1 base + 1 modular pattern-group, d_model<=256, <=4 experts.
    def reduced(self) -> "ModelConfig":
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        num_kv = num_heads // max(1, num_heads // num_kv)  # keep divisibility
        pre, bp, _, mp, _ = self._resolved_program()
        kw = dict(
            name=self.name + "-smoke",
            num_layers=len(pre) + len(bp) + len(mp),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=min(self.resolved_head_dim, 64),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            d_fusion=min(self.d_fusion, 128),
            q_block=64,
            kv_block=64,
            mlstm_chunk=16,
            compute_dtype="float32",
            remat="none",
        )
        if self.num_experts:
            kw.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                moe_d_ff=min(self.moe_d_ff or self.d_ff, 256) or 256,
            )
        if self.use_mla:
            kw.update(
                q_lora_rank=min(self.q_lora_rank, 96) or 0,
                kv_lora_rank=min(self.kv_lora_rank, 64),
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
                head_dim=0,
            )
        if self.is_encdec:
            kw.update(enc_layers=2, enc_seq_len=min(self.enc_seq_len, 64))
        if self.num_image_tokens:
            kw.update(num_image_tokens=16)
        if self.mrope_sections:
            hd = min(self.resolved_head_dim, 64)
            kw.update(mrope_sections=(hd // 4, hd // 8, hd // 8))

        # Shrink windows so sliding-window layers differ from global even
        # at smoke sequence lengths.
        def shrink(s: LayerSpec) -> LayerSpec:
            return dataclasses.replace(s, window=32 if s.window > 0 else s.window)

        kw["prefix_pattern"] = tuple(shrink(s) for s in pre)
        kw["base_pattern"] = tuple(shrink(s) for s in bp)
        kw["base_groups"] = 1
        kw["mod_pattern"] = tuple(shrink(s) for s in mp)
        kw["mod_groups"] = 1
        return self.replace(**kw).validate()


# ---------------------------------------------------------------------------
# Run config (paper hyper-parameters live here)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    """Hyper-parameters of one collaborative-training run, field for
    field and default for default the JAX package's ``RunConfig``.

    The eager IFL trainer (``repro_torch.core.ifl``) reads the clocking
    and fleet fields too:
    ``mode='async'`` with ``trace`` and ``tick`` drives it from an arrival
    trace, and ``n_population`` with ``cohort`` runs a population fleet.
    """

    n_clients: int = 4  # paper: N = 4
    tau: int = 10  # paper: τ = 10 local base-block steps per round
    rounds: int = 200  # paper: T = 200
    batch_size: int = 32  # paper: B = 32
    lr_base: float = 0.01  # paper: η_b
    lr_modular: float = 0.01  # paper: η_m
    d_fusion: int = 432  # paper's standardized fusion output dim
    dirichlet_alpha: float = 0.5  # paper's non-IID concentration
    optimizer: str = "sgd"  # paper uses plain SGD
    codec: str = "fp32"  # wire codec for z (see repro_torch.core.codec)
    # 'full' | 'k<K>' | 'bern<p>' | 'straggle(<frac>,<period>)'.
    participation: str = "full"
    # Fusion-cache staleness bound in rounds (None = never evict;
    # 0 = fresh uploads only).
    max_staleness: Optional[int] = None
    broadcast: str = "full"  # downlink policy: 'full' | 'delta'
    mode: str = "sync"
    trace: str = ""
    tick: float = 1.0
    n_population: int = 0
    cohort: int = 0
