"""Paper Table II: the four heterogeneous client models (KMNIST scale).

The port's copy of ``repro.models.small``, on the port's convention:
parameter trees of tensors (a list of ``{'w', 'b'}`` layers per block)
and plain functions. The trees keep the JAX layout, so weights carried
from the reference (``checkpoint.params_from_numpy``) apply unchanged:
conv weights are HWIO ``(3, 3, cin, cout)``, FC weights ``(din, dout)``.

Activations are NHWC at the model's boundary, and a flatten runs in
(H, W, C) order, as the reference's reshape of an NHWC tensor does. Two
layers depend on that order: client 2's ``fc 1568 -> 432`` and client
1's conv fusion layer (3 * 3 * 48 = 432 features). Inside a conv layer
the port permutes to NCHW for ``conv2d``/``max_pool2d`` and back.

Every conv layer is a SAME 3x3 conv, then the bias, then ReLU, then a
2x2 VALID max-pool; FC layers are followed by ReLU except the output
layer; client 1's conv fusion layer is flattened and then ReLU'd.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

D_FUSION = 432
NUM_CLASSES = 10

# Layer descriptors: ('conv', cin, cout) | ('fc', din, dout).
CLIENT_ARCHS: Dict[int, Dict[str, List[Tuple]]] = {
    1: {
        "base": [("conv", 1, 16), ("conv", 16, 32), ("conv", 32, 48)],
        "modular": [("fc", 432, 256), ("fc", 256, 128), ("fc", 128, 64),
                    ("fc", 64, 10)],
    },
    2: {
        "base": [("conv", 1, 16), ("conv", 16, 32), ("fc", 1568, 432)],
        "modular": [("fc", 432, 128), ("fc", 128, 10)],
    },
    3: {
        "base": [("fc", 784, 432)],
        "modular": [("fc", 432, 256), ("fc", 256, 128), ("fc", 128, 64),
                    ("fc", 64, 10)],
    },
    4: {
        "base": [("fc", 784, 1024), ("fc", 1024, 512), ("fc", 512, 432)],
        "modular": [("fc", 432, 10)],
    },
}


def _init_layers(generator, descs, device) -> List[Dict[str, Any]]:
    out = []
    for d in descs:
        if d[0] == "conv":
            _, cin, cout = d
            shape, fan_in, n_out = (3, 3, cin, cout), 9 * cin, cout
        else:
            _, din, dout = d
            shape, fan_in, n_out = (din, dout), din, dout
        w = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
        out.append({"w": w.to(device), "b": torch.zeros(n_out, device=device)})
    return out


def init_client_model(client_id: int, *, generator: torch.Generator,
                      device=None) -> Dict[str, Any]:
    """Parameters of Table-II client ``client_id``, with the reference's
    distributions (N(0, 1/fan_in) weights, zero biases). A torch
    generator draws other numbers than ``jax.random``; to start from the
    reference's own init, carry it with ``checkpoint.params_from_numpy``."""
    arch = CLIENT_ARCHS[client_id]
    return {
        "base": _init_layers(generator, arch["base"], device),
        "modular": _init_layers(generator, arch["modular"], device),
    }


def _conv_pool_relu(p, x: torch.Tensor) -> torch.Tensor:
    """NHWC in, NHWC out: SAME 3x3 conv + bias, ReLU, 2x2 VALID max-pool."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 p["b"], padding=1)
    y = F.max_pool2d(F.relu(y), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1)


def _apply_layers(layers, descs, x, *, is_output_block: bool):
    """x: (B, 28, 28, 1) NHWC images or (B, d) features."""
    n = len(descs)
    for i, (p, d) in enumerate(zip(layers, descs)):
        if d[0] == "conv":
            if x.dim() == 2:
                raise ValueError("conv after flatten")
            x = _conv_pool_relu(p, x)
        else:
            if x.dim() == 4:
                x = x.reshape(x.shape[0], -1)  # NHWC: (H, W, C) order
            x = x @ p["w"] + p["b"]
            if not (is_output_block and i == n - 1):
                x = F.relu(x)
    if x.dim() == 4:  # conv-based fusion layer (client 1): flatten + ReLU
        x = F.relu(x.reshape(x.shape[0], -1))
    return x


def client_base_apply(params, client_id: int, x) -> torch.Tensor:
    """x: (B, 28, 28, 1) -> z: (B, 432), the fusion-layer output z_k."""
    z = _apply_layers(params["base"], CLIENT_ARCHS[client_id]["base"], x,
                      is_output_block=False)
    if z.shape[-1] != D_FUSION:
        raise ValueError(f"client {client_id} fusion dim {z.shape[-1]}")
    return z


def client_modular_apply(params, client_id: int, z) -> torch.Tensor:
    """z: (B, 432) -> logits: (B, 10)."""
    return _apply_layers(params["modular"], CLIENT_ARCHS[client_id]["modular"],
                         z, is_output_block=True)


def client_apply(params, client_id: int, x) -> torch.Tensor:
    """Local end-to-end inference, eq. (10)."""
    return client_modular_apply(params, client_id,
                                client_base_apply(params, client_id, x))

