"""repro_torch's decode path against repro on the CPU: the flash decode
kernel's plain version against repro's Pallas kernel (interpret mode), the
ring-cache helpers, prefill, decode_step (with a wrapped, windowed ring)
and ServingEngine.generate on reduced qwen2-0.5b. Weights cross as .npz.
The CUDA kernel runs only on the card: ``python3 chip_smoke.py`` holds it
against ``flash_decode_ref`` there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_decode import flash_decode as jax_flash_decode  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models.model import cache_axes as jax_cache_axes  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.checkpointing import flatten, load_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (cache_axes, decode_step, init_cache,  # noqa: E402
                                load_jax_params, prefill)
from repro_torch.models.attention import (ring_from_prefill, ring_write_step,  # noqa: E402
                                          slot_positions)
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402

MODEL_TOL = dict(rtol=5e-4, atol=5e-4)
CACHE_TOL = dict(rtol=2e-5, atol=2e-5)
# the JAX kernel sweep's tolerances (tests/test_kernels.py)
DECODE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SWEEP = [(2, 4, 2, 128, 64, 50, None),    # partially filled cache
         (2, 4, 2, 128, 64, 127, None),   # exactly full
         (1, 8, 1, 256, 64, 300, 128),    # wrapped ring + window
         (2, 2, 2, 200, 32, 450, 96),     # cache len no multiple of a tile, wrapped
         (1, 4, 4, 64, 128, 10, None)]    # MHA


@pytest.mark.parametrize("B,H,HK,C,D,pos,window", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_ref_matches_pallas(B, H, HK, C, D, pos, window, dtype):
    r = np.random.default_rng(B * 1000 + C + pos)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((B, H, D), (B, HK, C, D), (B, HK, C, D)))
    want = jax_flash_decode(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                            jnp.int32(pos), window=window, interpret=True)
    tdt = getattr(torch, dtype)
    got = fd.flash_decode_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              pos, window=window)
    assert got.dtype == tdt and got.shape == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **DECODE_TOL[dtype])


def test_decode_attention_dispatches_cpu_tensors_to_the_plain_version():
    r = np.random.default_rng(3)
    q = torch.from_numpy(r.normal(size=(2, 4, 64)).astype(np.float32))
    k, v = (torch.from_numpy(r.normal(size=(2, 2, 24, 64)).astype(np.float32))
            for _ in range(2))
    before = fd.launches
    out = ops.decode_attention(q, k, v, 30, window=16)
    torch.testing.assert_close(out, fd.flash_decode_ref(q, k, v, 30, window=16))
    assert fd.launches == before


@pytest.mark.parametrize("pos,C", [(0, 8), (5, 8), (7, 8), (19, 8), (300, 200)])
def test_slot_positions_equal_reference(pos, C):
    want = np.asarray(jax_attention.slot_positions(jnp.int32(pos), C))
    np.testing.assert_array_equal(slot_positions(pos, C).numpy(), want)


def test_ring_write_step_equals_reference():
    r = np.random.default_rng(5)
    buf = r.normal(size=(2, 8, 2, 16)).astype(np.float32)
    val = r.normal(size=(2, 2, 16)).astype(np.float32)
    for pos in (3, 8, 21):
        want = np.asarray(jax_attention.ring_write_step(jnp.asarray(buf),
                                                        jnp.asarray(val), pos))
        tbuf = torch.from_numpy(buf.copy())
        got = ring_write_step(tbuf, torch.from_numpy(val), pos)
        assert got is tbuf                    # written in place
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,C", [(5, 8), (8, 8), (13, 8)])   # pad, copy, roll
def test_ring_from_prefill_equals_reference(S, C):
    vals = np.random.default_rng(S).normal(size=(2, S, 2, 16)).astype(np.float32)
    want = np.asarray(jax_attention.ring_from_prefill(jnp.asarray(vals), C))
    src = torch.from_numpy(vals)
    got = ring_from_prefill(src, C)
    assert got.data_ptr() != src.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Reduced qwen2-0.5b: reference params and the same weights in the
    port through a reference-written .npz."""
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    params = jax_init(jcfg, jax.random.key(0))
    path = str(tmp_path_factory.mktemp("npz") / "qwen2.npz")
    jax_save_tree(path, params)
    flat, _ = load_tree(path)
    return jcfg, cfg, params, load_jax_params(cfg, flat, device="cpu"), flat


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _prefill_and_decode(jcfg, cfg, params, model, tokens, total_len, n_steps):
    """Prefill, then ``n_steps`` decode steps fed the same tokens in both
    packages; asserts logits and caches agree at every step."""
    want, jcache = jax_prefill(jcfg, params, {"tokens": jnp.asarray(tokens)},
                               total_len=total_len)
    got, cache = prefill(cfg, model, {"tokens": torch.from_numpy(tokens).long()},
                         total_len=total_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    jflat, flat = flatten(jax.tree.map(np.asarray, jcache)), flatten(
        {s: {b: {n: t.numpy() for n, t in d.items()} for b, d in c.items()}
         for s, c in cache.items()})
    assert set(flat) == set(jflat) == {"main/blk/k", "main/blk/v"}
    for key in jflat:
        np.testing.assert_allclose(flat[key], jflat[key], **CACHE_TOL)
    r = np.random.default_rng(7)
    pos = tokens.shape[1]
    for _ in range(n_steps):
        tok = r.integers(0, cfg.vocab_size, tokens.shape[0]).astype(np.int32)
        want, jcache = jax_decode_step(jcfg, params, jcache, jnp.asarray(tok),
                                       jnp.int32(pos))
        got, cache = decode_step(cfg, model, cache, torch.from_numpy(tok).long(), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache["main"]["blk"][n].numpy(),
                                       np.asarray(jcache["main"]["blk"][n]), **CACHE_TOL)
        pos += 1
    return cache


def test_prefill_and_decode_steps_match_reference(shared):
    jcfg, cfg, params, model, _ = shared
    _prefill_and_decode(jcfg, cfg, params, model, _tokens(cfg, 2, 12, 1),
                        total_len=20, n_steps=4)


def test_windowed_ring_wraps_at_model_level(shared):
    """sliding_window=8 with a 12-token prompt: the rings hold 8 slots, the
    prompt's last 8 positions rolled into place, and decode wraps them."""
    jcfg, cfg, params, _, flat = shared
    jcfg, cfg = (c.with_overrides(sliding_window=8) for c in (jcfg, cfg))
    model = load_jax_params(cfg, flat, device="cpu")
    cache = _prefill_and_decode(jcfg, cfg, params, model, _tokens(cfg, 2, 12, 2),
                                total_len=32, n_steps=4)
    assert cache["main"]["blk"]["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                               cfg.resolved_head_dim)


def test_decode_step_writes_the_ring_in_place(shared):
    _, cfg, _, model, _ = shared
    tokens = torch.from_numpy(_tokens(cfg, 2, 6, 3)).long()
    _, cache = prefill(cfg, model, {"tokens": tokens}, total_len=10)
    kept = {n: t.clone() for n, t in cache["main"]["blk"].items()}
    _, out = decode_step(cfg, model, cache, tokens[:, -1], 6)
    assert out is cache
    k = cache["main"]["blk"]["k"]
    assert not torch.equal(k[:, :, 6], kept["k"][:, :, 6])
    torch.testing.assert_close(k[:, :, :6], kept["k"][:, :, :6], rtol=0, atol=0)


def test_init_cache_and_cache_axes_match_reference(shared):
    jcfg, cfg, _, _, _ = shared
    for jc, c in ((jcfg, cfg), (jcfg.with_overrides(sliding_window=8),
                                cfg.with_overrides(sliding_window=8))):
        want = jax_init_cache(jc, 3, 20)
        got = init_cache(c, 3, 20, device="cpu")
        for key, leaf in flatten(jax.tree.map(np.asarray, want)).items():
            s, b, n = key.split("/")
            assert tuple(got[s][b][n].shape) == leaf.shape
            assert not got[s][b][n].any()
        assert cache_axes(c) == jax_cache_axes(jc)


@pytest.mark.parametrize("cache_len", [None, 40])
def test_serving_engine_greedy_tokens_equal_reference(shared, cache_len):
    jcfg, cfg, params, model, _ = shared
    tokens = _tokens(cfg, 3, 10, 4)
    want = JaxServingEngine(jcfg, params, JaxServeConfig(
        max_new_tokens=7, cache_len=cache_len)).generate({"tokens": jnp.asarray(tokens)})
    got = ServingEngine(cfg, model, ServeConfig(max_new_tokens=7, cache_len=cache_len),
                        device="cpu").generate({"tokens": tokens})
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serving_engine_samples_with_its_generator(shared):
    _, cfg, _, model, _ = shared
    eng = ServingEngine(cfg, model, ServeConfig(max_new_tokens=6, temperature=0.8),
                        device="cpu")
    batch = {"tokens": _tokens(cfg, 2, 8, 5)}
    a = eng.generate(batch, torch.Generator().manual_seed(1))
    b = eng.generate(batch, torch.Generator().manual_seed(1))
    greedy = ServingEngine(cfg, model, ServeConfig(max_new_tokens=6),
                           device="cpu").generate(batch)
    assert torch.equal(a, b)
    assert a.shape == (2, 6) and 0 <= a.min() and a.max() < cfg.vocab_size
    assert torch.equal(a[:, 0], greedy[:, 0])   # token 0 is the prefill argmax
