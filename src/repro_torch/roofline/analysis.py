"""The roofline of one step on one H100 (the JAX package's
``repro/roofline/analysis.py``, for the card):

    compute    = FLOPs  / peak FLOP/s of the config's compute dtype
    memory     = bytes  / HBM bytes/s
    collective = 0      (one card: no link, no collective)

The FLOPs and bytes come from ``accounting.Accounting`` over an eager
step (on the meta device in a dry-run), where the reference reads them
from the compiled HLO of a TPU pod's program. The reference's
``collective_bytes_from_hlo`` has no counterpart: the port has no HLO
and, on one card, no collective; a multi-GPU target would bring both
back (ROADMAP.md).

``model_flops`` is the reference's, copied as it is: the same 6·N·D
convention and the same ``ifl_round`` phases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Hardware:
    """One card's peaks: NVIDIA's data sheet of the H100 SXM (dense, at
    its 700 W limit). ``link_bw`` is None: one card has no link."""

    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12  # tensor cores, bf16 / fp16
    peak_flops_fp32: float = 67e12  # outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    link_bw: Optional[float] = None

    def peak_flops(self, compute_dtype: str) -> float:
        """The peak that bounds a step computing in ``compute_dtype``
        (a config's ``compute_dtype`` name)."""
        return (self.peak_flops_bf16 if compute_dtype in ("bfloat16",
                                                          "float16")
                else self.peak_flops_fp32)


HW = Hardware()


def roofline_terms(cost: Dict[str, float], compute_dtype: str = "bfloat16",
                   hw: Hardware = HW,
                   model_flops_total: Optional[float] = None) -> Dict:
    """cost: {"flops", "bytes accessed"} of one step on one card (the
    reference's ``cost_analysis`` keys). The collective term is 0 and
    reported as such."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    peak = hw.peak_flops(compute_dtype)
    t_compute = flops / peak
    t_memory = nbytes / hw.hbm_bw
    terms = {
        "hardware": hw.name,
        "peak_flops": peak,
        "hbm_bw": hw.hbm_bw,
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": 0.0,
        "collective_note": "one card: no collective",
        "flops_total": flops,
        "bytes_total": nbytes,
        "collective_bytes_total": 0.0,
        "n_chips": 1,
    }
    dom = max(("compute_s", "memory_s"), key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")
    step = max(t_compute, t_memory)
    terms["bound_step_s"] = step
    if model_flops_total is not None:
        terms["model_flops_total"] = model_flops_total
        terms["useful_flops_ratio"] = model_flops_total / max(flops, 1.0)
        # MFU if the step ran at the roofline-bound time.
        terms["mfu_bound"] = model_flops_total / (max(step, 1e-12) * peak)
    return terms


# ------------------------------------------------------------ model flops


def model_flops(kind: str, *, params_base: float, params_mod: float,
                params_embed: float = 0.0, tokens: float,
                tau: int = 0, n_clients: int = 0) -> float:
    """Analytic 'useful' FLOPs (the 6·N·D convention; N = active params).

    kind:
      'dp_train'  — 6·N·D.
      'ifl_round' — base phase: τ steps of fwd(full) + bwd(base) =
                    τ·(2(Nb+Nm) + 4Nb)·D_c summed over clients; fusion
                    fwd pass 2·Nb·D_c; modular phase: each client trains
                    on ALL N·D_c tokens: 6·Nm·N·D_c per client.
      'prefill'   — 2·N·D.
      'decode'    — 2·N·D (D = batch tokens for one step).
    D/tokens = global tokens for the step; D_c = tokens per client.
    """
    N = params_base + params_mod
    if kind == "dp_train":
        return 6.0 * N * tokens
    if kind == "prefill" or kind == "decode":
        return 2.0 * N * tokens
    if kind == "ifl_round":
        dc = tokens / max(n_clients, 1)
        base_phase = n_clients * tau * (2 * N + 4 * params_base) * dc
        fusion = n_clients * 2 * params_base * dc
        modular = n_clients * 6 * params_mod * (n_clients * dc)
        return base_phase + fusion + modular
    raise ValueError(kind)
