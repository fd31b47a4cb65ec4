"""The port's DecodeSession against the JAX package's, on the same bridged
weights: prefill (logits and cache), fork + steps, a second prefill on a
forked session (the kernel's q_off path), parallel prefill ≡ step loop and
snapshot independence, at 1e-5 (the tolerance of tests/test_session.py).
Within the port, fork is bit-exact against an unshared batch-K prefill."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serve.session import DecodeSession as JaxSession  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402

TOL = 1e-5
CFGS = {"tiny_dense": lambda: tiny_cfg("dense"),
        "qwen2_smoke": lambda: jax_get_config("qwen2_1p5b", smoke=True)}


def _setup(name):
    jcfg = CFGS[name]()
    jp = jax_init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, config_from_jax(jcfg), tp


def _toks(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def _caches_close(jsess, tsess, upto):
    for g, grp in tsess.cache.items():
        for leaf in ("k", "v", "pos"):
            _close(grp[leaf][:, :, :upto].numpy(),
                   np.asarray(jsess.cache[g][leaf])[:, :, :upto])


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_fork_step_and_second_prefill_match_jax(name):
    """One session through the whole serving path: prefill (JAX in Pallas
    interpret mode), fork(3), 4 steps, then a second prefill on the forked
    session — cached slots as gateway ancestors, the kernel's q_off path."""
    jcfg, jp, tcfg, tp = _setup(name)
    V = jcfg.vocab_size
    prompt, tool = _toks(0, 10, V), _toks(1, 5, V)
    steps = np.stack([_toks(10 + i, 3, V) for i in range(4)], axis=1)

    js = JaxSession.create(jcfg, jp, buf_len=24)
    ts = DecodeSession.create(tcfg, tp, buf_len=24, device="cpu")
    with torch.inference_mode():
        _close(ts.prefill(prompt, impl="kernel"),
               js.prefill(prompt, impl="pallas"))
        _caches_close(js, ts, 10)
        jf, tf = js.fork(3), ts.fork(3)
        for i in range(4):
            _close(tf.step(steps[:, i]), jf.step(steps[:, i]))
        _close(tf.prefill(tool, impl="kernel"), jf.prefill(tool, impl="ref"))
        _caches_close(jf, tf, 19)
        _close(tf.step(steps[:, 0]), jf.step(steps[:, 0]))
    assert tf.t == jf.t == 20
    assert ts.stats.prefill_tokens == js.stats.prefill_tokens == 10 + 3 * 5
    assert ts.stats.decode_tokens == js.stats.decode_tokens == 3 * 5


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_parallel_prefill_matches_step_loop(impl):
    jcfg, jp, tcfg, tp = _setup("tiny_dense")
    toks = _toks(2, 10, jcfg.vocab_size)
    with torch.inference_mode():
        fast = DecodeSession.create(tcfg, tp, buf_len=14, device="cpu")
        assert fast._can_parallel_prefill(10)
        lg_fast = fast.prefill(toks, impl=impl)
        slow = DecodeSession.create(tcfg, tp, buf_len=14, device="cpu")
        lg_slow = slow._prefill_steps(toks)
        _close(lg_fast, lg_slow)
        for leaf in ("k", "v", "pos"):
            _close(fast.cache["g0"][leaf][:, :, :10],
                   slow.cache["g0"][leaf][:, :, :10])
        nxt = _toks(3, 1, jcfg.vocab_size)
        _close(fast.step(nxt), slow.step(nxt))
    # and the port's step loop is the JAX step loop
    js = JaxSession.create(jcfg, jp, buf_len=14)
    _close(lg_slow, js._prefill_steps(toks))


def test_fork_bitexact_vs_unshared_prefill():
    """Branches decoded off one forked prefix equal K sessions that each
    recompute the prefix, bit for bit (f32 on the CPU), while the forked
    group computes the prefix once."""
    _, _, tcfg, tp = _setup("tiny_dense")
    prompt = _toks(4, 8, tcfg.vocab_size)
    K, steps = 3, 4
    branch = np.stack([_toks(10 + k, steps, tcfg.vocab_size)
                       for k in range(K)])
    with torch.inference_mode():
        shared = DecodeSession.create(tcfg, tp, buf_len=16, device="cpu")
        shared.prefill(prompt)
        forked = shared.fork(K)
        assert forked.batch == K and forked.t == 8
        assert forked.stats is shared.stats
        solo = DecodeSession.create(tcfg, tp, batch=K, buf_len=16,
                                    device="cpu")
        solo.prefill(prompt)
        for t in range(steps):
            torch.testing.assert_close(forked.step(branch[:, t]),
                                       solo.step(branch[:, t]), atol=0,
                                       rtol=0)
    assert shared.stats.prefill_tokens == len(prompt)
    assert solo.stats.prefill_tokens == K * len(prompt)
    assert forked.stats.decode_tokens == K * steps
    # the parent is untouched by its branches' in-place steps
    assert shared.t == 8 and int(shared.cache["g0"]["pos"].max()) == 7


def test_snapshot_is_independent():
    jcfg, jp, tcfg, tp = _setup("tiny_dense")
    V = jcfg.vocab_size
    with torch.inference_mode():
        sess = DecodeSession.create(tcfg, tp, buf_len=16, device="cpu")
        sess.prefill(_toks(5, 6, V))
        snap = sess.snapshot()
        a, b = _toks(6, 1, V), _toks(7, 1, V)
        lg_a = sess.step(a)
        assert snap.t == 6 and sess.t == 7      # snapshot untouched
        lg_snap_b = snap.step(b)                 # diverges from sess
        lg_a2 = sess.step(a)                     # sess sees its own history
        assert snap.stats is sess.stats
    js = JaxSession.create(jcfg, jp, buf_len=16)
    js.prefill(_toks(5, 6, V))
    jsnap = js.snapshot()
    _close(lg_a, js.step(a))
    _close(lg_snap_b, jsnap.step(b))
    _close(lg_a2, js.step(a))
