"""The port's chunked attention (``models/attention.py::_attend_chunked``,
``attention(..., impl="chunked")``) against the reference's
(``repro/models/attention.py:104``, ``:246``) on the same numpy-seeded
inputs: o at 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py:63),
dq/dk/dv at atol = rtol = 1e-4 (tests/test_kernels_bwd.py:70).  Awkward
key lengths (1032: a divisor chunk; 1031, a prime: padded chunks), a
window, the encoder's bidirectional keys, gateway ancestors with padded
slots through ``attention``, the enc-dec model's loss and grads, and a
``--impl chunked`` launcher run against ``--impl ref``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs.base import AttnCfg as JAttnCfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs.base import AttnCfg  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from test_kernels import _gateway_meta, _tree_meta  # noqa: E402
from test_torch_remat import _batches, _max_rel, _setup  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOLS = {"f32": 2e-5, "bf16": 2e-2}
TOL_GRAD = 1e-4


def _case(name):
    """(q, k, v, do, i_idx, kv_last, pos_q, pos_k, window, bidirectional,
    valid_k, kv_chunk) as numpy, f32."""
    B, H, Kh, hd = 2, 4, 2, 16
    S, window, bidir, chunk = {"skv1032": (1032, None, False, 1024),
                               "prime1031": (1031, None, False, 1024),
                               "window": (200, 7, False, 64),
                               "bidirectional": (67, None, True, 16)}[name]
    rng = np.random.default_rng(S)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    kl, pos = (np.asarray(a) for a in _tree_meta(S % 97, B, S))
    valid = kl >= 0
    if bidir:
        valid[:, -9:] = False
    return (mk(B, S, H, hd), mk(B, S, Kh, hd), mk(B, S, Kh, hd),
            mk(B, S, H, hd), np.arange(S), kl, pos, pos, window, bidir,
            valid, chunk)


CASES = ["skv1032", "prime1031", "window", "bidirectional"]


def _jax_o(q, k, v, i_idx, kl, pq, pk, window, bidir, valid, chunk, dt):
    c = lambda a: jnp.asarray(a, dt)
    return jattn._attend_chunked(
        c(q), c(k), c(v), jnp.asarray(i_idx), jnp.asarray(kl),
        jnp.asarray(pq), jnp.asarray(pk), window, bidir, jnp.asarray(valid),
        q.shape[-1] ** -0.5, chunk)


def _port_o(q, k, v, i_idx, kl, pq, pk, window, bidir, valid, chunk, dt):
    c = lambda a: torch.from_numpy(a).to(dt)
    t = lambda a: torch.from_numpy(np.asarray(a))
    return tattn._attend_chunked(
        c(q), c(k), c(v), t(i_idx), t(kl), t(pq), t(pk), window, bidir,
        t(valid), q.shape[-1] ** -0.5, chunk)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_chunked_matches_jax_chunked(name, dtype):
    q, k, v, do, *meta = _case(name)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    j = _jax_o(q, k, v, *meta, jdt)
    o = _port_o(q, k, v, *meta, tdt)
    assert o.dtype == tdt and o.shape == j.shape
    tol = TOLS[dtype]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", CASES)
def test_chunked_grads_match_jax_chunked(name):
    q, k, v, do, *meta = _case(name)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(
        jattn._attend_chunked(q_, k_, v_, *(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in meta[:-1]), q.shape[-1] ** -0.5, meta[-1])
        * jnp.asarray(do)), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    t = lambda a: torch.from_numpy(np.asarray(a))
    i_idx, kl, pq, pk, window, bidir, valid, chunk = meta
    o = tattn._attend_chunked(tq, tk, tv, t(i_idx), t(kl), t(pq), t(pk),
                              window, bidir, t(valid), q.shape[-1] ** -0.5,
                              chunk)
    tg = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (tq, tk, tv))
    for nm, a, b in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_GRAD,
                                   rtol=TOL_GRAD, err_msg=nm)


def test_chunk_choice_is_the_reference_s():
    """1032 → 516 (a divisor within 4x); 1031 (prime) → 256 padded to
    1280; 84 at chunk 32 → 28; a short Skv is one chunk."""
    assert tattn._chunk_len(1032, 1024) == 516
    assert tattn._chunk_len(1031, 1024) == 256
    assert tattn._chunk_len(84, 32) == 28
    assert tattn._chunk_len(200, 1024) == 200


def test_attention_with_gateway_ancestors_matches_jax():
    """``attention(impl="chunked")`` with gateway ancestor K/V (padded
    slots hidden by their ``valid``) and a window, on the same weights:
    the reference's ``anc_ok`` keys ahead of the row's own."""
    B, S, A, D = 2, 64, 20, 32
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, window=24)
    jcfg, tcfg = JAttnCfg(**kw), AttnCfg(**kw)
    rng = np.random.default_rng(5)
    mk = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)
    p = {"wq": mk(D, 32), "wk": mk(D, 16), "wv": mk(D, 16), "wo": mk(32, D)}
    x = mk(B, S, D)
    kl, pos = (np.asarray(a) for a in _tree_meta(5, B, S))
    _, _, pos_k, anc_valid = _gateway_meta(5, B, S, A, (0, 7))
    anc_pos = np.asarray(pos_k)[:, :A]
    extra = dict(k=mk(B, A, 2, 8), v=mk(B, A, 2, 8), pos=anc_pos,
                 valid=np.asarray(anc_valid))
    meta = dict(pos_ids=pos + A, kv_last=kl, valid=kl >= 0)
    j = jattn.attention({n: jnp.asarray(a) for n, a in p.items()}, jcfg,
                        jnp.asarray(x), impl="chunked",
                        extra_kv={n: jnp.asarray(a)
                                  for n, a in extra.items()},
                        **{n: jnp.asarray(a) for n, a in meta.items()})
    t = lambda a: torch.from_numpy(np.asarray(a))
    o = tattn.attention({n: t(a) for n, a in p.items()}, tcfg, t(x),
                        impl="chunked",
                        extra_kv={n: t(a) for n, a in extra.items()},
                        **{n: t(a) for n, a in meta.items()})
    np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=TOLS["f32"],
                               rtol=TOLS["f32"])
    ref = tattn.attention({n: t(a) for n, a in p.items()}, tcfg, t(x),
                          impl="ref",
                          extra_kv={n: t(a) for n, a in extra.items()},
                          **{n: t(a) for n, a in meta.items()})
    ok = meta["valid"]
    np.testing.assert_allclose(o.numpy()[ok], ref.numpy()[ok],
                               atol=TOLS["f32"], rtol=TOLS["f32"])


def test_encdec_loss_and_grads_match_jax_chunked():
    """The enc-dec model at ``impl="chunked"`` in both packages (the
    encoder's bidirectional keys and the decoder's tree keys through the
    chunked scan): loss within 1e-5, grads within 1e-4 max-rel."""
    jcfg = tiny_cfg("audio")
    jp, tcfg, tp = _setup(jcfg)
    jb, tb = _batches(jcfg, tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_and_metrics(jcfg, p, b, "chunked"),
        has_aux=True))(jp, jb)
    tl, _, tg = value_and_grad(tcfg, tp, tb, "chunked")
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _max_rel(tree_leaves(tg), jax.tree.leaves(jg)) < 1e-4


def test_launcher_impl_chunked_matches_impl_ref(tmp_path):
    """Two CPU steps of ``python -m repro_torch.launch.train`` at
    ``--impl chunked`` and at ``--impl ref`` on the same seeded trees: the
    same losses and grad norms to 1e-5."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    hist = {}
    for impl in ("chunked", "ref"):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen1p5_0p5b", "--smoke", "--seq-len", "1024", "--steps", "2",
             "--device", "cpu", "--impl", impl, "--save",
             str(tmp_path / impl)], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert f"impl={impl}" in res.stdout
        hist[impl] = json.loads((tmp_path / impl / "history.json")
                                .read_text())
    assert len(hist["chunked"]) == len(hist["ref"]) >= 1
    for a, b in zip(hist["chunked"], hist["ref"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
