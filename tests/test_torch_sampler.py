"""The port's sampler (ops/sampling.py) against the JAX package's jitted
``sample_token`` on the CPU, at the routes the card's configurations take:
the dynamic top-k cutoff ``scalars[7]``, the direct top-k route at the
deployed vocab 259,344 (not a multiple of 256), planted ties at its k
boundary, and the two-stage route at 259,584 with ties across blocks that
straddle the k-th value; and ``sample_plan``'s route against the one
``top_k_exact`` takes. Tokens are exact at f32 with seeded inputs; the noise
is JAX's own for the step, handed to the plain version, and the port's own
(the (seed, step) key the engine passes) gives the same tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.ops import sampling as jsampling
from realtime_codec_agent_tpu_torch.ops import sampling as tsampling

SEED = 5
_jsample = jax.jit(jsampling.sample_token, static_argnames="top_k")


def _inputs(logits, settings, window, dyn_k=None):
    """Both frameworks' arguments for one draw: JAX's and the port's
    scalars (8 entries with ``dyn_k``), bias tables and window."""
    jst = jsampling.SamplerSettings(**settings)
    tst = tsampling.SamplerSettings(**settings)
    js, ts = jst.scalars(), tst.scalars()
    if dyn_k is not None:
        js = jnp.concatenate([js, jnp.array([dyn_k], jnp.float32)])
        ts = torch.cat([ts, torch.tensor([dyn_k], dtype=torch.float32)])
    jb, tb = jst.bias_arrays(), tst.bias_arrays()
    jw, tw = jsampling.make_window(window), tsampling.make_window(window)
    return (js, *jb, *jw), (ts, *tb, *tw)


def _draw_both(logits, settings, window, step, top_k, dyn_k=None):
    """(JAX's token, the port's token with JAX's noise, the port's token
    from the (seed, step) key)."""
    jargs, targs = _inputs(logits, settings, window, dyn_k)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    j_tok = int(_jsample(jnp.asarray(logits), key, *jargs, top_k=top_k))
    k = tsampling.k_for(top_k, logits.shape[0])
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (k,))))
    t_tok = int(tsampling.sample_token(torch.from_numpy(logits), noise, *targs, top_k=top_k))
    t_key = int(tsampling.sample_token(torch.from_numpy(logits), (SEED, step), *targs, top_k=top_k))
    return j_tok, t_tok, t_key


def _jax_top(logits, settings, window, top_k, dyn_k=None):
    """JAX's top-k (ids, values after the cutoff) of the processed logits,
    the chain of ``jsampling.sample_token`` up to its draw."""
    (s, bid, bval, wid, wmask), _ = _inputs(logits, settings, window, dyn_k)
    x = jnp.asarray(logits).at[bid].add(bval)
    x = jsampling.apply_penalties(x, wid, wmask, s[3], s[4], s[5])
    x = jnp.where(jnp.arange(x.shape[0], dtype=jnp.float32) >= s[6], x, jsampling.NEG_INF)
    k = tsampling.k_for(top_k, x.shape[0])
    vals, ids = jsampling.top_k_exact(x, k)
    if dyn_k is not None:
        vals = jnp.where((dyn_k <= 0) | (jnp.arange(k) < dyn_k), vals, jsampling.NEG_INF)
    return np.asarray(ids), np.asarray(vals)


def _port_top(logits, settings, window, top_k, dyn_k=None):
    _, targs = _inputs(logits, settings, window, dyn_k)
    dbg = {}
    tsampling.sample_token_plain(torch.from_numpy(logits), None, *targs, top_k=top_k, debug=dbg)
    return dbg["ids"].numpy(), dbg["vals"].numpy()


def _logits(vocab, seed):
    return (np.random.default_rng(seed).normal(size=(vocab,)) * 3).astype(np.float32)


# ------------------------------------------------------------ scalars[7]

@pytest.mark.parametrize("vocab", [1320, 32768])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("dyn_k", [0.0, 1.0, 5.0, 40.0])
def test_dyn_k_cutoff_matches_jax(dyn_k, mode, vocab):
    """The dynamic top-k cutoff scalars[7] (0 = the full static width) cuts
    the port's top-k as it cuts JAX's; greedy and sampled tokens equal JAX's
    over 6 steps, with JAX's noise and with the port's (seed, step) key."""
    settings = dict(temp=0.0) if mode == "greedy" else dict(temp=1.5, top_p=1.0, min_p=0.0)
    window = np.random.default_rng(1).integers(0, vocab, size=20).tolist()
    for step in range(6):
        logits = _logits(vocab, 100 + step)
        j_tok, t_tok, t_key = _draw_both(logits, settings, window, step, top_k=100, dyn_k=dyn_k)
        assert j_tok == t_tok == t_key, (dyn_k, mode, step, j_tok, t_tok, t_key)
    ids, vals = _port_top(logits, settings, window, 100, dyn_k)
    jids, jvals = _jax_top(logits, settings, window, 100, dyn_k)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vals, jvals)
    if dyn_k > 0:
        assert (vals[int(dyn_k):] == np.float32(tsampling.NEG_INF)).all()


def test_sample_token_on_cpu_takes_the_plain_version():
    """A CPU tensor runs sample_token_plain (its .calls counts, the kernel's
    .launches does not); the (seed, step) key draws what the port's noise
    tensor for that step draws."""
    logits = torch.from_numpy(_logits(1320, 3))
    _, targs = _inputs(logits.numpy(), dict(temp=1.0, top_p=1.0, min_p=0.0), [1, 2, 3])
    calls, launches = tsampling.sample_token_plain.calls, tsampling.sample_token.launches
    for step in range(4):
        noise = tsampling.gumbel_noise(SEED, step, 100, "cpu")
        assert int(tsampling.sample_token(logits, (SEED, step), *targs)) == int(
            tsampling.sample_token(logits, noise, *targs))
    assert tsampling.sample_token_plain.calls == calls + 8
    assert tsampling.sample_token.launches == launches


# --------------------------------------------------- the deployed vocab

VOCAB_DIRECT = 259344  # 128,256 + 10 + 131,072, padded to 8: 1,013 x 256 + 16
VOCAB_TWO_STAGE = 259584  # DuplexLMConfig's default: 1,014 x 256

FULL_VOCAB_CASES = {
    "greedy": (dict(temp=0.0), None),
    "codec_pinned": (dict(temp=1.0, top_p=1.0, min_p=0.0, min_token_id=128266), None),
    "text_end_audio_bias": (dict(temp=1.0, top_p=1.0, min_p=0.0, logit_bias=((128259, -100.0),)), None),
    "penalties_bias_floor": (dict(temp=0.8, top_p=0.9, min_p=0.05, repeat_penalty=1.3, frequency_penalty=0.4,
                                  presence_penalty=0.7, logit_bias=((5, 4.0), (128259, -100.0)), min_token_id=3),
                             None),
    "dyn_k": (dict(temp=0.9, top_p=0.95, min_p=0.02), 5.0),
}


def _window_on_top(logits, rng):
    """A penalty window that hits the top logits (where penalties move the
    top-k) and random ids."""
    top = np.argsort(-logits, kind="stable")[:30].tolist()
    return top[::3] + rng.integers(0, logits.shape[0], size=20).tolist() + top[:4]


@pytest.mark.parametrize("case", sorted(FULL_VOCAB_CASES))
def test_direct_route_at_deployed_vocab_matches_jax(case):
    """V = 259,344 takes the direct route (V % 256 != 0: the whole-vocab
    sort): one step per settings case, the token and the top-k equal JAX's."""
    settings, dyn_k = FULL_VOCAB_CASES[case]
    assert tsampling.sample_plan(VOCAB_DIRECT, 100).route == "direct"
    logits = _logits(VOCAB_DIRECT, 11)
    window = _window_on_top(logits, np.random.default_rng(2))
    j_tok, t_tok, t_key = _draw_both(logits, settings, window, step=3, top_k=100, dyn_k=dyn_k)
    assert j_tok == t_tok == t_key, (case, j_tok, t_tok, t_key)
    ids, vals = _port_top(logits, settings, window, 100, dyn_k)
    jids, jvals = _jax_top(logits, settings, window, 100, dyn_k)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vals, jvals)


def _plant_ties(x, rng, ranks, copies):
    """Set ``copies`` random entries and the entries ranked ``ranks`` (a
    range, by value) to the value ranked ``ranks.start``: a run of equal
    values across many 256-blocks around that rank."""
    order = np.argsort(-x, kind="stable")
    v = x[order[ranks.start]]
    x[rng.choice(x.shape[0], size=copies, replace=False)] = v
    x[order[ranks.start:ranks.stop]] = v
    return x


@pytest.mark.parametrize("top_k", [40, 100])
def test_direct_route_planted_ties_match_jax(top_k):
    """Ties straddling the k-th value at V = 259,344 resolve in index order,
    as lax.top_k resolves them; also a floor that leaves fewer than k ids
    (NEG_INF ties). Top-k ids, values and tokens over 8 steps equal JAX's."""
    rng = np.random.default_rng(top_k)
    logits = _plant_ties(_logits(VOCAB_DIRECT, 21), rng, range(top_k - 6, top_k + 6), 25)
    cases = [dict(temp=4.0, top_p=1.0, min_p=0.0),
             dict(temp=0.0, min_token_id=VOCAB_DIRECT - top_k // 2)]
    for settings in cases:
        ids, vals = _port_top(logits, settings, [], top_k)
        jids, jvals = _jax_top(logits, settings, [], top_k)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(vals, jvals)
        for step in range(8 if settings["temp"] > 0 else 1):
            j_tok, t_tok, t_key = _draw_both(logits, settings, [], step, top_k)
            assert j_tok == t_tok == t_key, (settings, step, j_tok, t_tok, t_key)


@pytest.mark.parametrize("top_k", [40, 100])
def test_two_stage_route_ties_across_blocks_match_jax(top_k):
    """V = 259,584 takes the two-stage route: values equal to the k-th
    planted in many 256-blocks, among them blocks whose maxima tie, so the
    block rank decides before the position and elements of unselected blocks
    that tie the k-th value stay out. Top-k ids, values and tokens equal
    JAX's."""
    assert tsampling.sample_plan(VOCAB_TWO_STAGE, top_k).route == "two_stage"
    rng = np.random.default_rng(top_k + 1)
    x = _plant_ties(_logits(VOCAB_TWO_STAGE, 31), rng, range(top_k - 8, top_k + 4), 40)
    kth = np.sort(x)[::-1][top_k - 1]
    # three blocks whose maxima tie the k-th value, each with a second copy
    for b in (7, 500, 1013):
        x[b * 256 + 3] = x[b * 256 + 200] = kth
    # the block of rank 0 (the largest value) late in the vocab holds a copy
    # too: the two-stage route takes it before every earlier copy
    x[1000 * 256] = x.max() + 1.0
    x[1000 * 256 + 1] = kth
    settings = dict(temp=4.0, top_p=1.0, min_p=0.0)
    ids, vals = _port_top(x, settings, [], top_k)
    jids, jvals = _jax_top(x, settings, [], top_k)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vals, jvals)
    lax_ids = np.asarray(jax.lax.top_k(jnp.asarray(x), top_k)[1])
    assert not np.array_equal(ids, lax_ids)  # the planted ties do tell the two routes apart
    for step in range(8):
        j_tok, t_tok, t_key = _draw_both(x, settings, [], step, top_k)
        assert j_tok == t_tok == t_key, (step, j_tok, t_tok, t_key)


# ------------------------------------------------------------- the plan

REPO_VOCABS = [1320, 32768, 131368, 259344, 259584, 283024]


@pytest.mark.parametrize("vocab", REPO_VOCABS)
@pytest.mark.parametrize("k", [40, 100, 1024])
def test_sample_plan_route_is_top_k_exacts(vocab, k):
    """sample_plan picks the route JAX's top_k_exact takes, read from its
    result: a tie at the k-th value planted so that the direct route takes
    index 0 and the two-stage route index 257 (block 1 outranks block 0).
    The kernel's launch covers the vocab in whole 256-blocks."""
    k = min(k, vocab)
    plan = tsampling.sample_plan(vocab, k)
    x = np.full((vocab,), -1.0, np.float32)
    x[0], x[256], x[257] = 1.0, 5.0, 1.0
    free = [i for i in range(2 * 256, vocab, 256)] if k <= vocab // 256 else [i for i in range(vocab) if i not in (0, 256, 257)]
    x[free[: k - 2]] = 10.0 + np.arange(k - 2, dtype=np.float32)
    ids = np.asarray(jsampling.top_k_exact(jnp.asarray(x), k)[1])
    assert ids[k - 1] == (257 if plan.route == "two_stage" else 0), (vocab, k, plan)
    np.testing.assert_array_equal(tsampling.top_k_exact(torch.from_numpy(x), k)[1].numpy(), ids)
    assert plan.k == k and plan.slice % 256 == 0 and 1 <= plan.blocks <= 16
    assert (plan.blocks - 1) * plan.slice < vocab <= plan.blocks * plan.slice
    assert plan.group == 0 or -(-vocab // plan.group) >= k


# ------------------------------------------------------- rows under raw keys

@pytest.mark.parametrize("vocab", [1320, 32768])
def test_rows_raw_keys_match_jax(vocab):
    """S1 over rows under raw threefry keys (k1, k2, step), the batched
    engine's: the port's row draw (the plain version here) against
    ``jax.vmap`` of the JAX sampler under ``vmap(fold_in)(row_keys, step)``,
    ids equal; keys (0, seed, step) draw what (seed, step) draws."""
    rows, top_k = 6, 1024
    rng = np.random.default_rng(vocab)
    logits = (rng.normal(size=(rows, vocab)) * 3).astype(np.float32)
    cases = [dict(top_k=top_k, top_p=1.0, min_p=0.0, temp=1.0), dict(top_k=top_k, temp=0.0),
             dict(top_k=top_k, top_p=0.9, min_p=0.05, temp=0.8, repeat_penalty=1.3, presence_penalty=0.7),
             dict(top_k=top_k, top_p=0.95, temp=1.0, frequency_penalty=0.4)] * 2
    dyn_k = [0.0, 0.0, 50.0, 20.0, 0.0, 1.0]
    raw = rng.integers(0, 2**32, size=(rows, 2)).astype(np.uint32)
    raw[0] = jax.random.PRNGKey(77)  # a seed's key among them
    steps = rng.integers(0, 2**31, size=rows)
    windows = [rng.integers(0, vocab, size=int(n)).tolist() for n in (0, 10, 64, 30, 5, 64)]
    jargs, targs = zip(*(_inputs(logits[r], cases[r], windows[r], dyn_k[r]) for r in range(rows)))
    keys = jax.vmap(jax.random.fold_in)(jnp.asarray(raw), jnp.asarray(steps, jnp.uint32))
    want = jax.vmap(lambda lg, key, *a: jsampling.sample_token(lg, key, *a, top_k=top_k))(
        jnp.asarray(logits), keys, *(jnp.stack(col) for col in zip(*jargs)))
    tkeys = torch.from_numpy(np.concatenate([raw.astype(np.int64), steps[:, None].astype(np.int64)], axis=1))
    stacked = [torch.stack(col) for col in zip(*targs)]
    got = tsampling.sample_token_rows(torch.from_numpy(logits), tkeys, *stacked, top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seeded = tsampling.sample_token_rows(torch.from_numpy(logits)[:1], torch.tensor([[77, int(steps[0])]]),
                                         *(t[:1] for t in stacked), top_k=top_k)
    assert int(seeded[0]) == int(got[0])


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device: the kernels are compiled and run only on the card")
@pytest.mark.parametrize("top_k", [100, 1024])
@pytest.mark.parametrize("vocab", [1320, 259344])
def test_rows_raw_keys_kernel_matches_plain(vocab, top_k):
    """On the card: 16 rows under random raw keys in one launch of S1
    against the plain draw (tools/sampler_times.check_raw_keys: top-k ids
    and values bit for bit, probabilities within 2 ulp, the id equal outside
    boundary draws; (0, seed, step) keys == (seed, step))."""
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    rows, keys = st.raw_key_rows(vocab, top_k, 16, torch.device("cuda"), seed=vocab + top_k)
    assert st.check_raw_keys(rows, keys, log=lambda *_: None)["draws"] == 16
