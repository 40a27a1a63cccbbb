"""Channel mixer: gated (SwiGLU/GeGLU) MLP."""

from __future__ import annotations

from repro_torch.models import modules as nn


def init_mlp(generator, d_model: int, d_ff: int, *, device=None, lead=()):
    return {
        "w_gate": nn.init_linear(generator, d_model, d_ff, device=device,
                                 lead=lead),
        "w_up": nn.init_linear(generator, d_model, d_ff, device=device,
                               lead=lead),
        "w_down": nn.init_linear(generator, d_ff, d_model, device=device,
                                 lead=lead),
    }


def mlp_forward(p, x, act: str = "silu"):
    a = nn.activation(act)
    return nn.linear(p["w_down"],
                     a(nn.linear(p["w_gate"], x)) * nn.linear(p["w_up"], x))
