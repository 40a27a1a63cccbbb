"""The attention kernels' outputs at hd 64 and 128 on fixed inputs, as
sha256 digests, shared by ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``). ``FINGERPRINTS`` holds the digests of
the kernels before head dims other than 64 and 128 existed, so at 64
and 128 the padded kernels must reproduce them bit for bit. To write
them again from a checkout of other kernels, run
``attn_fingerprints(ops)`` on a card with that checkout's ``src`` and
this directory on the path, and dump the dict as JSON (indent 1, keys
sorted) into ``FINGERPRINTS``.

(numpy and torch only: the card tests import no JAX.)
"""

import hashlib
from pathlib import Path

import numpy as np
import torch

FINGERPRINTS = (Path(__file__).resolve().parent / "data"
                / "attn_fingerprints_hd64_128.json")


def attn_fingerprints(ops) -> dict:
    """{case: sha256} of every output of flash_attention (o, lse),
    flash_attention_bwd (dq, dk, dv) and flash_decode at hd 64 and 128,
    fp32 and bf16, on inputs drawn by numpy from fixed seeds: GQA, a
    window, a partial last tile, a split decode with a masked row. The
    digest is of the fp32 widening (exact for bf16), so equal digests are
    equal bits."""

    def arr(rng, shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(dtype)

    def digest(t):
        return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()
                              ).hexdigest()

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for B, S, H, KVH, hd, window in ((1, 129, 4, 2, 64, -1),
                                         (1, 129, 4, 2, 64, 48),
                                         (1, 200, 4, 4, 128, -1),
                                         (2, 77, 8, 2, 128, 16)):
            rng = np.random.default_rng(S + hd + window)
            q, do = (arr(rng, (B, S, H, hd), dtype) for _ in range(2))
            k, v = (arr(rng, (B, S, KVH, hd), dtype) for _ in range(2))
            o, lse = ops.flash_attention_fwd(q, k, v, window=window)
            grads = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                            window=window)
            key = f"attn B{B} S{S} H{H} KVH{KVH} hd{hd} w{window} {dn}"
            for name, t in zip(("o", "lse", "dq", "dk", "dv"),
                               (o, lse, *grads)):
                out[f"{key} {name}"] = digest(t)
        for B, L, KVH, G, hd, lengths in ((3, 65, 2, 1, 64, [65, 7, 0]),
                                          (2, 4097, 2, 4, 128, [4097, 300]),
                                          (2, 300, 2, 16, 128, [300, 0]),
                                          (4, 4097, 4, 1, 64,
                                           [4097, 1000, 5, 0])):
            rng = np.random.default_rng(L + G + hd)
            q = arr(rng, (B, 1, KVH, G, hd), dtype)
            k, v = (arr(rng, (B, L, KVH, hd), dtype) for _ in range(2))
            valid = (torch.arange(L, device="cuda")[None, :]
                     < torch.tensor(lengths, device="cuda")[:, None])
            out[f"decode B{B} L{L} KVH{KVH} G{G} hd{hd} {dn}"] = digest(
                ops.cached_attn_decode(q, k, v, valid))
    torch.cuda.synchronize()
    return out
