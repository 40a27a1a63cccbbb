"""What "agree" means for two wire payloads of one codec computed from
projections that were summed in different orders (numpy only, so the
card tests, which import no JAX, share it with the CPU parity tests).

A projection y summed in another order differs in its last bits, and an
integer code whose y sits on a rounding edge may flip by one step. The
budget is the JAX package's own for its fused projection kernels
(``tests/test_wire_fused.py:215-233``): fewer than 2% of the codes
differ, each by at most one step. For top-k, the decoded rows agree
within one quantum: a position that only one side keeps holds a value no
larger in magnitude than that row's selection threshold (its smallest
kept magnitude). Float leaves (scales, kept values, sketch sums) agree
within ``rtol`` of the tensor's largest magnitude.
"""

import numpy as np

FLIP_BUDGET = 0.02


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def floats_close(a, b, rtol, label=""):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= rtol * scale, (label, err, rtol * scale)
    return err


def unpack_int4(q4, d):
    q4 = _np(q4).astype(np.int32)
    q = np.stack([(q4 & 0xF) - 8, (q4 >> 4) - 8], axis=-1)
    return q.reshape(*q4.shape[:-1], -1)[..., :d]


def codes(kind, payload, d):
    """The integer codes of a row scheme's payload, (rows, d) int32."""
    if kind == "int8_row":
        q = _np(payload["q"]).astype(np.int32)
    else:
        q = unpack_int4(payload["q4"], d)
    return q.reshape(-1, d)


def codes_close(a, b, label=""):
    """-> the (rows, d) bool mask of flipped codes, within the budget."""
    diff = np.abs(a - b)
    assert diff.max(initial=0) <= 1, (label, int(diff.max()))
    flips = diff != 0
    assert flips.mean() < FLIP_BUDGET, (label, float(flips.mean()))
    return flips


def topk_dense(payload, d):
    vals = _np(payload["values"]).reshape(-1, _np(payload["values"]).shape[-1])
    idx = _np(payload["indices"]).reshape(vals.shape).astype(np.int64)
    dense = np.zeros((vals.shape[0], d), np.float64)
    kept = np.zeros((vals.shape[0], d), bool)
    np.put_along_axis(dense, idx, vals.astype(np.float64), axis=1)
    np.put_along_axis(kept, idx, True, axis=1)
    return dense, kept, np.abs(vals).min(axis=1)


def topk_close(a, b, d, rtol, label=""):
    """-> the (rows, d) bool mask of positions only one side keeps."""
    da, ka, ta = topk_dense(a, d)
    db, kb, tb = topk_dense(b, d)
    scale = max(1.0, float(np.abs(db).max(initial=0.0)))
    both = ka & kb
    assert np.all(np.abs(da - db)[both] <= rtol * scale), label
    only = ka ^ kb
    assert only.mean() < FLIP_BUDGET, (label, float(only.mean()))
    thresh = np.maximum(ta, tb)[:, None] * (1 + rtol) + rtol * scale
    assert np.all((np.abs(da) + np.abs(db))[only] <= np.broadcast_to(
        thresh, only.shape)[only]), label
    return only


def payload_close(kind, got, want, d, rtol, label=""):
    """Leaf names, dtypes and shapes equal; codes within the budget;
    floats within rtol. -> the (rows, d) mask of positions that differ
    in their discrete part (no mask for the sketch: all zeros)."""
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for name in want:
        ga, wa = _np(got[name]), _np(want[name])
        assert ga.dtype == wa.dtype and ga.shape == wa.shape, (
            label, name, ga.dtype, ga.shape, wa.dtype, wa.shape)
    if kind in ("int8_row", "int4"):
        floats_close(got["scale"], want["scale"], rtol, f"{label}/scale")
        return codes_close(codes(kind, got, d), codes(kind, want, d), label)
    if kind == "topk":
        return topk_close(got, want, d, rtol, label)
    floats_close(got["sketch"], want["sketch"], rtol, f"{label}/sketch")
    return np.zeros((_np(want["sketch"]).reshape(-1, _np(
        want["sketch"]).shape[-1]).shape[0], d), bool)


def residual_close(got, want, flips, rtol, label=""):
    """EF residuals e' compared on the rows where the codes agree (a
    flipped code changes that row's e' and its clip factor); the rows
    with a flip are counted in the codes' budget already."""
    g, w = _np(got).reshape(flips.shape), _np(want).reshape(flips.shape)
    ok = ~flips.any(axis=1)
    assert ok.mean() > 0.5, (label, float(ok.mean()))
    return floats_close(g[ok], w[ok], rtol, label)
