"""The wire kernels' launch plan keyed by the card (``ops.wire_plan``,
``ops.autotune_wire_plan``) and the choices read from the card's SM
count (``ops.decode_splits``), on the CPU: the plan's read side, its
keys, the tuner's refusal to time anything without a card, and the
split table at the H100 SXM's 132 SMs."""

import json

import numpy as np
import pytest
import torch

import _launch_rules as rules
from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels import ops, ref

CARD = "NVIDIA_H100_80GB_HBM3"


@pytest.fixture
def plan_file(tmp_path, monkeypatch):
    """A plan file of its own under tmp_path, read afresh, on a card
    named CARD."""
    path = tmp_path / "wire_plan.json"
    monkeypatch.setenv("REPRO_TORCH_WIRE_PLAN_CACHE", str(path))
    monkeypatch.setattr(ops, "_wire_cache_mem", None)
    monkeypatch.setattr(ops, "card_name", lambda device: CARD)
    yield path
    ops._wire_cache_mem = None


@pytest.mark.parametrize("kind,knob", [("encode", "warps"),
                                       ("proj_encode", "tile"),
                                       ("decode_proj", "tile")])
def test_wire_plan_without_a_file_is_the_kernels_rule(plan_file, kind, knob):
    assert not plan_file.exists()
    assert ops.wire_plan("int8_row", 432, kind) == {knob: -1}
    assert ops.wire_plan("ef(int4)", 1024, kind, "cuda") == {knob: -1}


def test_wire_plan_reads_the_entry_of_this_card_and_no_other(plan_file):
    entries = {
        f"{CARD}|encode|int8_row|d432": {"warps": 4, "us": 1.5},
        f"{CARD}|proj_encode|int8_row|d432": {"tile": 0, "us": 9.0},
        f"{CARD}|decode_proj|ef(int4)|d432": {"tile": 3, "us": 6.0},
        # Other cards, codecs, dims and kinds: none of them applies.
        "NVIDIA_H100_PCIe|encode|int4|d432": {"warps": 8},
        f"{CARD}|encode|int4|d1024": {"warps": 2},
    }
    plan_file.write_text(json.dumps(entries))
    assert ops.wire_plan("int8_row", 432, "encode", "cuda") == {"warps": 4}
    assert ops.wire_plan("int8_row", 432, "proj_encode") == {"tile": 0}
    assert ops.wire_plan("ef(int4)", 432, "decode_proj") == {"tile": 3}
    assert ops.wire_plan("int4", 1024, "encode") == {"warps": 2}
    # Same card, another (codec, d, kind): the rule.
    assert ops.wire_plan("int4", 432, "encode") == {"warps": -1}
    assert ops.wire_plan("int8_row", 433, "encode") == {"warps": -1}
    assert ops.wire_plan("int8_row", 432, "decode_proj") == {"tile": -1}
    assert ops.wire_plan("ef(int4)", 432, "proj_encode") == {"tile": -1}


def test_wire_plan_reads_its_file_once(plan_file):
    plan_file.write_text(json.dumps({f"{CARD}|encode|int4|d432":
                                     {"warps": 1}}))
    assert ops.wire_plan("int4", 432) == {"warps": 1}
    plan_file.write_text(json.dumps({}))       # not read again
    assert ops.wire_plan("int4", 432) == {"warps": 1}
    ops._wire_cache_mem = None                 # a fresh read
    assert ops.wire_plan("int4", 432) == {"warps": -1}


@pytest.mark.parametrize("kind", ["encode", "proj_encode", "decode_proj"])
def test_autotune_wire_plan_raises_without_a_card(plan_file, kind):
    """The plan never times anything on the CPU, and writes nothing."""
    with pytest.raises(ValueError, match="card"):
        ops.autotune_wire_plan("int8_row", 432, kind=kind, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="card"):
            ops.autotune_wire_plan("int8_row", 432, kind=kind)
    assert not plan_file.exists()


def test_decode_splits_at_132_sms_are_the_pinned_table():
    for shape, want in rules.DECODE_SPLITS_132.items():
        assert ops.decode_splits(*shape) == want, shape
        assert ops.decode_splits(*shape, 132) == want, shape


def test_decode_splits_on_another_card_move_the_blocks_not_the_result():
    """At 114 SMs (the H100 PCIe) a long cache splits otherwise, and the
    plain mirror of the kernel's split-and-merge arithmetic still holds
    to the plain attention within the same 1e-5."""
    B, KVH, G, L, hd = 4, 2, 4, 4097, 64
    at_132, at_114 = (ops.decode_splits(B, KVH, G, L, hd, sms)
                      for sms in (132, 114))
    assert at_132 != at_114
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, 1, KVH, G, hd),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, L, KVH, hd),
                                                 dtype=np.float32))
            for _ in range(2))
    valid = torch.from_numpy(rng.random((B, L)) < 0.7)
    want = ref.cached_attn_decode_ref(q, k, v, valid)
    for splits in (at_132, at_114):
        got = ref.flash_decode_split_ref(q, k, v, valid, splits=splits,
                                         tile=ops.decode_tile_rows(hd))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fused_wire_report_names_the_fused_encodes_plan(plan_file):
    rep = ops.fused_wire_report("int8_row", (32, 432))
    assert rep["proj_epilogue_plan"] == {"tile": -1}
    assert rep["encode_warps"] == ops.encode_warps(32, 432, "int8_row")
    plan_file.write_text(json.dumps({
        f"{CARD}|proj_encode|int8_row|d432": {"tile": 1},
        f"{CARD}|encode|int8_row|d432": {"warps": 2}}))
    ops._wire_cache_mem = None
    rep = ops.fused_wire_report("int8_row", (32, 432))
    assert rep["proj_epilogue_plan"] == {"tile": 1}
    assert rep["encode_warps"] == 2
