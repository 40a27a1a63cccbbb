"""Channel mixer: gated (SwiGLU/GeGLU) MLP."""

from __future__ import annotations

import torch

from repro_torch.models import modules as nn


def init_mlp(generator, d_model: int, d_ff: int, *, device=None, lead=(),
             dtype=torch.float32):
    kw = dict(device=device, lead=lead, dtype=dtype)
    return {
        "w_gate": nn.init_linear(generator, d_model, d_ff, **kw),
        "w_up": nn.init_linear(generator, d_model, d_ff, **kw),
        "w_down": nn.init_linear(generator, d_ff, d_model, **kw),
    }


def mlp_forward(p, x, act: str = "silu"):
    a = nn.activation(act)
    return nn.linear(p["w_down"],
                     a(nn.linear(p["w_gate"], x)) * nn.linear(p["w_up"], x))
