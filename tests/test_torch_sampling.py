"""The port's sampler against ``jax.random`` and the JAX package's lane
sampler on the CPU.

``repro_torch.serve.prng`` is the reference's threefry2x32 key chain as
torch integer ops: ``split``, ``random_bits`` and ``uniform`` are held
bitwise to ``jax.random``'s, at single keys and at a (W, 2) batch of
keys over (W, V) counters, V not a multiple of 4 among them. ``gumbel``
takes two logs, which XLA and torch each round to within an ulp but not
always to the same float, so it is held to 2 ulps of max(1, |g|) (near
g = 0 a float's own ulp shrinks far below the logs' rounding). The lane's
``sample_token`` gives the reference's ``sample_token`` token on 200
(key, logits, temperature, top-k) cases, top-k 0, 1 and V, ties at the
top-k threshold and temperature 0 among them, and ``generate``'s
non-greedy draws are the reference's ``generate``'s on the same logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.launch import serve as jserve
from repro.serve import lanes as jlanes
from repro_torch.launch import serve as tserve
from repro_torch.serve import lanes, prng

SEEDS = [0, 7, -3, 2**31 - 1]
SHAPES = [(), (10,), (3, 7), (151,), (2, 3, 5)]


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _batch_keys(n, seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, torch.from_numpy(_words(keys))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert np.array_equal(_words(key), tkey.numpy())
    for n in (2, 3, 5):
        assert np.array_equal(_words(jax.random.split(key, n)),
                              prng.split(tkey, n).numpy()), n
    # The chain: split, then split the first half again, three times.
    for _ in range(3):
        key, tkey = jax.random.split(key)[0], prng.split(tkey)[0]
    assert np.array_equal(_words(key), tkey.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_equal_jax(seed, shape):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert np.array_equal(_words(jax.random.bits(key, shape)),
                          prng.random_bits(tkey, shape).numpy())
    for lo, hi in ((0.0, 1.0), (np.finfo(np.float32).tiny, 1.0),
                   (-2.5, 3.0)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(tkey, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), \
            (lo, hi)


@pytest.mark.parametrize("W,V", [(4, 13), (2, 1000), (3, 4099)])
def test_batched_keys_draw_each_rows_own_stream(W, V):
    """A (W, 2) batch of keys over (W, V) counters: row w is
    jax.random's draw under key w alone, split and bits alike."""
    keys, tkeys = _batch_keys(W, seed=V)
    want_bits = np.stack([_words(jax.random.bits(k, (V,))) for k in keys])
    assert np.array_equal(prng.random_bits(tkeys, (V,)).numpy(), want_bits)
    want_split = np.stack([_words(jax.random.split(k)) for k in keys])
    assert np.array_equal(prng.split(tkeys).numpy(), want_split)
    want_u = np.stack([np.asarray(jax.random.uniform(k, (V,)))
                       for k in keys])
    got_u = prng.uniform(tkeys, (V,)).numpy()
    assert np.array_equal(got_u.view(np.int32), want_u.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulps(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.gumbel(key, (50_000,)))
    got = prng.gumbel(tkey, (50_000,)).numpy()
    ulp = np.finfo(np.float32).eps * np.maximum(1.0, np.abs(want))
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got.astype(np.float64) - want) <= 2 * ulp)


def _cases(n=200, V=61, seed=0):
    """n (logits, key, temperature, top_k) rows. A third of the rows
    hold logits rounded to quarters, so the k-th largest logit ties with
    others; top-k cycles through 0, 1, V and values between; every
    fifth row is greedy (temperature 0)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, V)).astype(np.float32) * 3
    logits[::3] = np.round(logits[::3] * 4) / 4
    top_k = np.array([(0, 1, V, 5, 2, 17, V - 1)[i % 7] for i in range(n)],
                     np.int32)
    temp = rng.uniform(0.3, 2.0, n).astype(np.float32)
    temp[::5] = 0.0
    keys = np.array(jax.random.split(jax.random.PRNGKey(seed), n))
    return logits, keys, temp, top_k


def test_sample_token_equals_the_reference_on_200_cases():
    logits, keys, temp, top_k = _cases()
    want = np.asarray(jax.jit(jax.vmap(jlanes.sample_token))(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
        jnp.asarray(top_k)))
    got = lanes.sample_token(
        torch.from_numpy(logits), torch.from_numpy(_words(keys)),
        torch.from_numpy(temp), torch.from_numpy(top_k.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)
    # The cases reach what they are meant to: ties at the threshold,
    # greedy rows, top-1 rows, and sampled tokens off the argmax.
    kth = np.sort(logits, axis=1)[:, ::-1][
        np.arange(len(top_k)), np.clip(top_k - 1, 0, logits.shape[1] - 1)]
    assert np.sum((logits == kth[:, None]).sum(1) > 1) > 10
    greedy = temp == 0
    assert np.array_equal(want[greedy], logits[greedy].argmax(1))
    assert np.array_equal(want[top_k == 1], logits[top_k == 1].argmax(1))
    assert np.sum(want[~greedy] != logits[~greedy].argmax(1)) > 50


def test_one_row_and_a_batch_agree():
    """``sample_token`` on one (V,) row with a (2,) key is row w of the
    batched call."""
    logits, keys, temp, top_k = map(torch.from_numpy, _cases(n=6, seed=4))
    keys, top_k = keys.long(), top_k.long()
    batch = lanes.sample_token(logits, keys, temp, top_k)
    for w in range(6):
        one = lanes.sample_token(logits[w], keys[w], temp[w], top_k[w])
        assert one.dim() == 0 and int(one) == int(batch[w])


def test_request_key_is_the_references():
    from repro.serve import Request as JaxRequest
    from repro_torch.serve import Request

    for rid, seed in ((0, 0), (5, 3), (2**33 + 1, -1)):
        want = jlanes.request_key(JaxRequest(rid=rid, tenant="t", prompt=[1],
                                             seed=seed))
        got = lanes.request_key(Request(rid=rid, tenant="t", prompt=[1],
                                        seed=seed))
        assert np.array_equal(got, _words(want))


V_GEN, B_GEN, P_GEN = 37, 3, 4


def _table(n):
    """(n, B, 1, V) fp32 logits, one set a position, from a seed."""
    return np.random.default_rng(11).standard_normal(
        (n, B_GEN, 1, V_GEN)).astype(np.float32)


@pytest.mark.parametrize("greedy,seed", [(False, 0), (False, 5),
                                         (True, 0)])
def test_generate_draws_equal_the_references(monkeypatch, greedy, seed):
    """Both packages' ``generate`` over a stand-in model whose logits at
    position t are row t of one table: the port's tokens are the
    reference's, greedy and sampled (the key split once a token from
    PRNGKey(seed)). Token g is drawn from row P - 1 + g."""
    gen = 6
    table = _table(P_GEN + gen)
    jt = jnp.asarray(table)

    monkeypatch.setattr(jserve, "init_decode_cache",
                        lambda cfg, b, n: jnp.zeros(()))
    monkeypatch.setattr(jserve, "lm_prefill",
                        lambda p, cfg, c, toks, kv: (jt[toks.shape[1] - 1],
                                                     c))
    monkeypatch.setattr(jserve, "lm_decode_step",
                        lambda p, cfg, c, t, pos, kv: (jt[pos], c))
    monkeypatch.setattr(tserve, "init_decode_cache",
                        lambda cfg, b, n, device=None: None)
    monkeypatch.setattr(tserve, "lm_prefill",
                        lambda p, cfg, c, toks, kv: (
                            torch.from_numpy(table[toks.shape[1] - 1]), c))
    monkeypatch.setattr(tserve, "lm_decode_step",
                        lambda p, cfg, c, t, pos, kv: (
                            torch.from_numpy(table[pos]), c))
    prompts = np.arange(B_GEN * P_GEN).reshape(B_GEN, P_GEN) % V_GEN
    want = np.asarray(jserve.generate(
        None, None, jnp.asarray(prompts, jnp.int32), gen, greedy=greedy,
        seed=seed))
    got = tserve.generate(None, None, torch.from_numpy(prompts), gen,
                          greedy=greedy, seed=seed)
    assert got.shape == (B_GEN, P_GEN + gen)
    assert np.array_equal(got.numpy(), want)
    if not greedy:
        assert np.any(want[:, P_GEN:] != table[P_GEN - 1:P_GEN - 1 + gen,
                                               :, 0].argmax(-1).T)
