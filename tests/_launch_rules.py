"""The port's launch rules at the H100 SXM's 132 SMs, written out in
plain Python (no torch, no numpy), for checks that the rules read from
the card's SM count choose what they chose at 132 (``chip_smoke.py``
phase 4q and ``tests/test_torch_cuda.py``).

* ``fusion_proj.cu`` #4: the first tile of its list (largest first)
  whose grid reaches its wave (132 blocks; 66 for fp32 tiles under 128
  rows), else the last; the fused encode's fp32 tile: 16 x 64 where its
  grid has 132 blocks, else 8 x 16. Indices as ``ops.fused_tile``'s.
* ``rmsnorm.cu``: the register kernel's grid of at most 2 blocks an SM
  over the rows' slots, else the two-pass kernel's (a row a warp or a
  block).
* ``ops.decode_splits`` at 132: ``DECODE_SPLITS_132``.

The functions take another SM count too (``sms``), so a card test holds
the kernels' choices on any card. ``KnobSpy`` records what the wrappers
pass to the C entries.
"""

SMS_132 = 132

# (BM, BN) of #4's tiles in list order, and whether a tile takes half a
# wave (fp32 tiles under 128 rows).
PROJ_TILES = {"float32": [(128, 128), (64, 64), (8, 16)],
              "bfloat16": [(128, 128), (32, 32), (16, 32)]}
ENCODE_F32_BIG = (16, 64)

# ops.decode_splits(B, KVH, G, L, hd) at 132 SMs -> (S, chunk): the
# serving path, long caches, llama3-405b's G 16, the split cases of
# chip_smoke.py and longer ones.
DECODE_SPLITS_132 = {
    (4, 16, 1, 64, 64): (1, 64),
    (4, 16, 1, 4096, 64): (8, 512),
    (4, 16, 1, 32768, 64): (8, 4096),
    (4, 8, 16, 4096, 128): (16, 256),
    (4, 2, 1, 1, 64): (1, 64),
    (4, 2, 1, 65, 64): (2, 64),
    (4, 16, 1, 4097, 64): (8, 576),
    (4, 8, 16, 4097, 128): (15, 288),
    (2, 2, 4, 300, 128): (10, 32),
    (4, 4, 1, 4097, 24): (33, 128),
    (1, 16, 1, 32768, 128): (32, 1024),
    (2, 8, 4, 8192, 64): (32, 256),
    (1, 1, 1, 300000, 128): (127, 2368),
}


def _blocks(M, N, bm, bn):
    return -(-M // bm) * -(-N // bn)


def proj_tile(M, N, dtype="float32", sms=SMS_132):
    """#4's tile index (at 132 SMs unless ``sms``)."""
    tiles = PROJ_TILES[dtype]
    for i, (bm, bn) in enumerate(tiles[:-1]):
        half = dtype == "float32" and bm < 128
        if _blocks(M, N, bm, bn) >= (sms // 2 if half else sms):
            return i
    return len(tiles) - 1


def encode_tile(M, N, dtype="float32", sms=SMS_132):
    """The fused encode's tile index (bf16: its one tile)."""
    if dtype == "bfloat16":
        return 0
    return 0 if _blocks(M, N, *ENCODE_F32_BIG) >= sms else 1


def rmsnorm_grid(rows, d, aligned=True, sms=SMS_132):
    """rmsnorm.cu's blocks; ``aligned``: the rows all on 16 bytes (d a
    multiple of 4 fp32 or 8 bf16 elements, x and y on 16 bytes)."""
    tpr = 32 if d <= 1024 else 256
    per_block = 256 // tpr
    if aligned and d <= 8192:
        slots = sms * 2 * per_block
        per = -(-rows // slots)
        return -(-rows // (per * per_block))
    return -(-rows // per_block)


class KnobSpy:
    """While active, records the arguments of every C entry the kernel
    wrappers call (through ``ops._c_fn``), so a check can read the team
    or tile, and the SM count, a launch was given."""

    def __init__(self, ops):
        self.ops, self.calls = ops, []

    def __enter__(self):
        self._orig = self.ops._c_fn

        def c_fn(lib, name, argtypes):
            fn = self._orig(lib, name, argtypes)

            def call(*args):
                self.calls.append((name, args))
                return fn(*args)
            return call
        self.ops._c_fn = c_fn
        return self

    def __exit__(self, *exc):
        self.ops._c_fn = self._orig

    def count(self, name):
        return sum(n == name for n, _ in self.calls)

    def knob(self, name):
        """(team or tile, SM count) given to the last call of the C entry
        ``name``; wire_encode takes no SM count (None)."""
        args = [a for n, a in self.calls if n == name][-1]
        if name == "wire_encode":
            return args[-2], None
        return args[-3], args[-2]
