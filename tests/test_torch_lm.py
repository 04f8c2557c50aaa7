"""The port's LM serving path against the reference package, on the CPU at
the reduced configs of the four dense GQA architectures and the two MoE
ones (qwen3-moe with GQA, deepseek-v2-lite with MLA).

The reference initialises its parameters; ``params_from_reference`` loads
them into the port's modules (the two packages' generators differ).  Both
run float32.  Tolerances: layers 1e-6 (the same float32 arithmetic, library
kernels summing in other orders); attention, prefill and decode logits and
caches 2e-5 (a few float32 products deep); the prefill-then-decode
consistency at the reference's own 2e-4 / 2e-3 (tests/test_arch_smoke.py);
greedy tokens, batches and parameter counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.data.specs import make_batch as jax_make_batch
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models.zoo import build_model as jax_build_model
from repro.models.zoo import count_params_abstract
from repro.train.serving import greedy_generate as jax_greedy
from repro.train.serving import pad_caches as jax_pad_caches
from repro_torch.configs import base
from repro_torch.data.specs import make_batch
from repro_torch.launch.serve import run_serving
from repro_torch.models import attention, layers
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import padded_vocab
from repro_torch.models.zoo import build_model, count_params
from repro_torch.train.serving import greedy_generate, pad_caches

DENSE_GQA = ["qwen2_5_3b", "qwen2_72b", "granite_3_8b", "internlm2_20b"]
MOE = ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]
# the reference's count_params_abstract / active_params at full width
MOE_COUNTS = {"deepseek_v2_lite_16b": (16_210_311_168, 2_663_233_536),
              "qwen3_moe_30b_a3b": (30_532_634_624, 3_353_544_704)}
LAYER_TOL = 1e-6
TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_base.get_arch(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(base.get_arch(arch).reduced(), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module", params=DENSE_GQA + MOE)
def pair(request):
    """(reference model, its params, port model) at the arch's reduced
    config, the port's parameters loaded from the reference's."""
    jcfg, tcfg = _cfgs(request.param)
    jmodel = jax_build_model(jcfg)
    params, _ = jmodel.init(jax.random.key(0))
    model = build_model(tcfg, device="cpu")
    model.net.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def _batches(jcfg, tcfg, S, B=2, seed=2):
    shape = base.ShapeConfig("t", seq_len=S, global_batch=B, kind="prefill")
    jshape = jax_base.ShapeConfig("t", seq_len=S, global_batch=B, kind="prefill")
    return jax_make_batch(jcfg, jshape, seed=seed), make_batch(tcfg, shape, seed=seed)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", jax_base.list_archs())
def test_get_arch_answers_as_the_reference(arch):
    assert base.list_archs() == jax_base.list_archs()
    ref = jax_base.get_arch(arch)
    got = base.get_arch(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(ref.reduced())
    assert got.resolved_head_dim == ref.resolved_head_dim
    for name, shape in jax_base.SHAPES.items():
        assert dataclasses.asdict(base.SHAPES[name]) == dataclasses.asdict(shape)
        assert base.cell_supported(got, base.SHAPES[name]) == jax_base.cell_supported(ref, shape)


@pytest.mark.parametrize("arch", DENSE_GQA + MOE)
def test_count_params_matches_the_reference_at_full_width(arch):
    """Full width on the meta device: shapes only, nothing allocated."""
    model = build_model(base.get_arch(arch), device="meta")
    assert count_params(model) == count_params_abstract(jax_base.get_arch(arch))
    if arch == "qwen2_5_3b":
        assert count_params(model) == 3_397_627_904
        assert padded_vocab(model.cfg) == 152064
    if arch in MOE_COUNTS:
        assert count_params(model) == MOE_COUNTS[arch][0]


@pytest.mark.parametrize("arch,match", [
    ("rwkv6_7b", "rwkv"),
    ("zamba2_1_2b", "hybrid"),
    ("seamless_m4t_medium", "encoder-decoder"),
    ("internvl2_26b", "frontend"),
])
def test_unported_families_raise(arch, match):
    with pytest.raises(NotImplementedError, match=match):
        build_model(base.get_arch(arch).reduced(), device="meta")


def test_moe_router_is_float32_under_a_bf16_config():
    """The reference's router weight is float32 whatever cfg.dtype is; a
    bf16 tree loads bit for bit, and prefill routes and serves in bf16."""
    arch = "deepseek_v2_lite_16b"
    jcfg = jax_base.get_arch(arch).reduced()
    tcfg = base.get_arch(arch).reduced()
    assert tcfg.dtype == "bfloat16"
    params, _ = jax_build_model(jcfg).init(jax.random.key(0))
    model = build_model(tcfg, device="cpu")
    state = params_from_reference(jax.tree.map(np.asarray, params))
    assert state["layers.0.mlp.router.w"].dtype == torch.float32
    assert state["layers.0.mlp.wi"].dtype == torch.bfloat16
    model.net.load_state_dict(state)
    for name, t in model.net.named_parameters():
        assert t.dtype == (torch.float32 if name.endswith("router.w") else torch.bfloat16)
        assert torch.equal(t, state[name]), name
    jb, tb = _batches(jcfg, tcfg, S=9)
    want, _ = jax_build_model(jcfg).prefill(params, jb)
    got, _ = model.prefill(tb)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got.float()), w, atol=5e-2 * float(np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("arch", MOE)
def test_use_flash_routes_gqa_through_the_kernel_and_never_mla(arch, monkeypatch):
    """prefill(use_flash=True) calls flash_attention once a layer under GQA
    (qwen3-moe) and never under MLA (deepseek): the reference's mla_apply
    has no use_flash."""
    cfg = dataclasses.replace(base.get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg, device="cpu")
    model.init(0)
    calls = []
    inner = attention.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return inner(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", counting)
    _, tb = _batches(cfg, cfg, S=9)
    model.prefill(tb, use_flash=True)
    assert len(calls) == (0 if cfg.mla else cfg.n_layers)


@pytest.mark.parametrize("arch", jax_base.list_archs())
def test_make_batch_gives_the_reference_batch(arch):
    jcfg, tcfg = _cfgs(arch)
    for kind in ("prefill", "train"):
        jb = jax_make_batch(jcfg, jax_base.ShapeConfig("b", 24, 3, kind), seed=5)
        tb = make_batch(tcfg, base.ShapeConfig("b", 24, 3, kind), seed=5)
        assert list(tb) == list(jb)
        for key in jb:
            if key in ("tokens", "targets"):
                assert tb[key].dtype == torch.int32
                np.testing.assert_array_equal(_np(tb[key]), np.asarray(jb[key]))
            else:
                _close(tb[key], jb[key], 0.0)


# ------------------------------------------------------------------ layers
def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_dense_and_swiglu_match_the_reference():
    x, w, b, wi, wg, wo = _rng_arrays(1, (2, 5, 8), (8, 6), (6,), (8, 12), (8, 12), (12, 8))
    t = [torch.from_numpy(a) for a in (x, w, b, wi, wg, wo)]
    _close(layers.dense(t[0], t[1], t[2]), jax_layers.dense_apply({"w": w, "b": b}, x), LAYER_TOL)
    _close(layers.dense(t[0], t[1]), jax_layers.dense_apply({"w": w}, x), LAYER_TOL)
    _close(layers.swiglu(t[0], t[3], t[4], t[5]),
           jax_layers.swiglu_apply({"wi": {"w": wi}, "wg": {"w": wg}, "wo": {"w": wo}}, x),
           LAYER_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norms_compute_in_float32_as_the_reference(dtype):
    x, scale, bias = _rng_arrays(2, (3, 4, 16), (16,), (16,))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tx = torch.from_numpy(x).to(dtype)
    ts, tb = torch.from_numpy(scale).to(dtype), torch.from_numpy(bias).to(dtype)
    tol = LAYER_TOL if dtype == torch.float32 else 1e-2
    got = layers.rmsnorm(tx, ts, eps=1e-6)
    assert got.dtype == dtype
    want = jax_layers.rmsnorm_apply({"scale": jnp.asarray(scale, jd)}, jnp.asarray(x, jd))
    _close(got.float(), np.asarray(want, np.float32), tol)
    got = layers.layernorm(tx, ts, tb, eps=1e-5)
    want = jax_layers.layernorm_apply(
        {"scale": jnp.asarray(scale, jd), "bias": jnp.asarray(bias, jd)}, jnp.asarray(x, jd))
    _close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (8, 1e4), (128, 1e6)])
def test_rope_matches_the_reference(head_dim, theta):
    pos = np.arange(37)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), head_dim, theta)
    jcos, jsin = jax_layers.rope_angles(jnp.asarray(pos), head_dim, theta)
    _close(cos, jcos, LAYER_TOL)
    _close(sin, jsin, LAYER_TOL)
    (x,) = _rng_arrays(3, (2, 3, 37, head_dim))
    _close(layers.rope_apply(torch.from_numpy(x), cos, sin),
           jax_layers.rope_apply(jnp.asarray(x), jcos, jsin), 1e-5)
    # the decode form: one position, (1, d/2) angles
    c1, s1 = layers.rope_angles(torch.tensor([36]), head_dim, theta)
    jc1, js1 = jax_layers.rope_angles(jnp.asarray([36]), head_dim, theta)
    _close(layers.rope_apply(torch.from_numpy(x[:, :, :1]), c1, s1),
           jax_layers.rope_apply(jnp.asarray(x[:, :, :1]), jc1, js1), 1e-5)


def test_embedding_gathers_the_reference_rows():
    (table,) = _rng_arrays(4, (9000, 8))  # above the reference's one-hot threshold
    ids = np.random.default_rng(5).integers(0, 9000, size=(2, 7)).astype(np.int32)
    got = layers.embedding(torch.from_numpy(table), torch.from_numpy(ids))
    want = jax_layers.embedding_apply({"table": jnp.asarray(table)}, jnp.asarray(ids))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --------------------------------------------------------------- attention
@pytest.fixture(scope="module")
def gqa():
    D, H, Hkv, hd = 32, 4, 2, 8
    p, _ = jax_attn.gqa_init(jax.random.key(7), D, H, Hkv, hd, jnp.float32, bias=True)
    p = jax.tree.map(lambda a: a + 0.01, p)  # nonzero biases
    mod = attention.gqa_init(D, H, Hkv, hd, bias=True, dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert float(mod.wq.b.abs().max()) == 0.0 and mod.wq.w.shape == (D, H * hd)
    mod.load_state_dict(params_from_reference(jax.tree.map(np.asarray, p)))
    return p, mod, dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("mode", ["causal", "full", "cross"])
def test_gqa_apply_matches_the_reference(gqa, mode, use_flash):
    p, mod, dims = gqa
    x, x_kv = _rng_arrays(8, (2, 11, 32), (2, 7, 32))
    cos, sin = jax_layers.rope_angles(jnp.arange(11), 8, 1e6)
    kw = dict(mode=mode, use_flash=use_flash)
    if mode == "cross":
        kw_j = dict(kw, x_kv=jnp.asarray(x_kv))
        kw_t = dict(kw, x_kv=torch.from_numpy(x_kv))
    else:
        kw_j, kw_t = kw, kw
    want, wcache = jax_attn.gqa_apply(p, jnp.asarray(x), cos=cos, sin=sin, **dims, **kw_j)
    got, gcache = attention.gqa_apply(
        mod, torch.from_numpy(x), cos=torch.from_numpy(np.array(cos)),
        sin=torch.from_numpy(np.array(sin)), **dims, **kw_t)
    _close(got, want)
    if mode == "cross":
        assert gcache is None and wcache is None
    else:
        _close(gcache["k"], wcache["k"])
        _close(gcache["v"], wcache["v"])


def test_gqa_chunked_path_matches_the_dense_path(gqa, monkeypatch):
    """Above ATTN_CHUNK_THRESHOLD the q-chunked form runs; forced at a small
    length it gives the dense form's output, as the reference's does."""
    p, mod, dims = gqa
    (x,) = _rng_arrays(9, (1, 21, 32))
    cos, sin = layers.rope_angles(torch.arange(21), 8, 1e6)
    dense, _ = attention.gqa_apply(mod, torch.from_numpy(x), cos=cos, sin=sin, **dims)
    monkeypatch.setattr(attention, "ATTN_CHUNK_THRESHOLD", 4)
    monkeypatch.setattr(attention, "ATTN_Q_CHUNK", 8)
    q, k, v = (torch.from_numpy(a) for a in _rng_arrays(10, (1, 4, 21, 8), (1, 2, 21, 8),
                                                         (1, 2, 21, 8)))
    chunked = attention._sdpa_chunked(q, k, v, scale=8**-0.5, causal=True, q_chunk=8)
    want = jax_attn._sdpa_chunked(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                  jnp.asarray(v.numpy()), scale=8**-0.5, causal=True, q_chunk=8)
    _close(chunked, want)
    got, _ = attention.gqa_apply(mod, torch.from_numpy(x), cos=cos, sin=sin, **dims)
    _close(got, dense)


@pytest.mark.parametrize("mode", ["decode", "cross_decode"])
def test_gqa_decode_modes_match_the_reference(gqa, mode):
    p, mod, dims = gqa
    x, ck, cv = _rng_arrays(11, (2, 1, 32), (2, 2, 9, 8), (2, 2, 9, 8))
    pos = 5
    ck[:, :, pos + 1:] = 0.0
    cv[:, :, pos + 1:] = 0.0
    cos, sin = jax_layers.rope_angles(jnp.asarray([pos]), 8, 1e6)
    want, wcache = jax_attn.gqa_apply(
        p, jnp.asarray(x), cos=cos, sin=sin, mode=mode, pos=jnp.asarray(pos, jnp.int32),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, **dims)
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, gcache = attention.gqa_apply(
        mod, torch.from_numpy(x), cos=torch.from_numpy(np.array(cos)),
        sin=torch.from_numpy(np.array(sin)), mode=mode, pos=pos, cache=tcache, **dims)
    _close(got, want)
    _close(gcache["k"], wcache["k"])
    _close(gcache["v"], wcache["v"])
    if mode == "decode":  # written in place, at pos only
        assert gcache["k"] is tcache["k"]
        np.testing.assert_array_equal(_np(gcache["k"][:, :, :pos]), ck[:, :, :pos])


def test_causal_mask_matches_the_reference():
    for Sq, Skv, off in ((5, 5, 0), (3, 7, 2), (6, 4, 0)):
        np.testing.assert_array_equal(_np(attention.causal_mask(Sq, Skv, off)),
                                      np.asarray(jax_attn.causal_mask(Sq, Skv, off)))


# ------------------------------------------------------------ whole model
def test_prefill_logits_and_caches_match_the_reference(pair):
    jmodel, params, model = pair
    jb, tb = _batches(jmodel.cfg, model.cfg, S=13)
    want, wcaches = jmodel.prefill(params, jb)
    for use_flash in (None, True):
        got, gcaches = model.prefill(tb, use_flash=use_flash)
        _close(got, want)
        assert set(gcaches) == set(wcaches) == ({"c", "kr"} if model.cfg.mla else {"k", "v"})
        for name in wcaches:
            _close(gcaches[name], wcaches[name])


def test_decode_step_matches_the_reference(pair):
    jmodel, params, model = pair
    jb, tb = _batches(jmodel.cfg, model.cfg, S=10)
    S = 10
    _, wcaches = jmodel.prefill(params, {"tokens": jb["tokens"][:, :-1]})
    wcaches = jax_pad_caches(jmodel.cfg, wcaches, S - 1, to_len=S)
    want, wnew = jmodel.decode_step(params, jb["tokens"][:, -1:], wcaches,
                                    jnp.asarray(S - 1, jnp.int32))
    _, gcaches = model.prefill({"tokens": tb["tokens"][:, :-1]}, capacity=S)
    got, gnew = model.decode_step(tb["tokens"][:, -1:], gcaches, S - 1)
    _close(got, want)
    for name in wnew:
        _close(gnew[name], wnew[name])


def test_prefill_then_decode_equals_the_longer_prefill(pair):
    """tests/test_arch_smoke.py's consistency check, in the port."""
    _, _, model = pair
    _, tb = _batches(model.cfg, model.cfg, S=8)
    full, _ = model.prefill(tb)
    _, caches = model.prefill({"tokens": tb["tokens"][:, :-1]})
    caches = pad_caches(model.cfg, caches, 7, to_len=8)
    dec, _ = model.decode_step(tb["tokens"][:, -1:], caches, 7)
    np.testing.assert_allclose(_np(dec), _np(full), atol=2e-4, rtol=2e-3)


def test_greedy_tokens_equal_the_reference(pair):
    jmodel, params, model = pair
    jb, tb = _batches(jmodel.cfg, model.cfg, S=6, seed=3)
    want = np.asarray(jax_greedy(jmodel, params, jb, max_new_tokens=4))
    stats = {}
    got = greedy_generate(model, tb, max_new_tokens=4, stats=stats)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    assert stats["decode_steps"] == 4 and stats["prefill_s"] >= 0 and stats["decode_s"] >= 0


def test_pad_caches_keeps_the_prefix_and_zero_fills(pair):
    """Along seq axis 3 of GQA's k/v, axis 2 of MLA's c/kr; the reference's
    pad_caches gives the same arrays."""
    jmodel, params, model = pair
    jb, tb = _batches(model.cfg, model.cfg, S=8)
    _, caches = model.prefill(tb)
    padded = pad_caches(model.cfg, caches, 8, to_len=16)
    axis = 2 if model.cfg.mla else 3
    for name, c in caches.items():
        assert padded[name].shape[axis] == 16
        assert torch.equal(padded[name].narrow(axis, 0, 8), c)
        assert not padded[name].narrow(axis, 8, 8).any()
    _, big = model.prefill(tb, capacity=16)
    name = next(iter(big))
    assert pad_caches(model.cfg, big, 8, to_len=16)[name] is big[name]
    for name in caches:
        assert torch.equal(big[name], padded[name])
    _, wcaches = jmodel.prefill(params, jb)
    wpadded = jax_pad_caches(jmodel.cfg, wcaches, 8, to_len=16)
    for name in wpadded:
        assert wpadded[name].shape == padded[name].shape
        _close(padded[name], wpadded[name])


# -------------------------------------------------------- the entry point
def test_run_serving_on_the_cpu():
    lines = []
    run = run_serving(arch="qwen2_5_3b", batch=2, prompt_len=9, new_tokens=3, seed=1,
                      device="cpu", log=lines.append)
    cfg = run.model.cfg
    assert cfg.dtype == "float32" and cfg.d_model == 64
    assert run.tokens.shape == (2, 3) and run.tokens.dtype == torch.int32
    assert 0 <= int(run.tokens.min()) and int(run.tokens.max()) < padded_vocab(cfg)
    assert run.n_params == count_params(run.model) and run.decode_steps == 3
    again = run_serving(arch="qwen2_5_3b", batch=2, prompt_len=9, new_tokens=3, seed=1,
                        device="cpu", log=lines.append)
    assert torch.equal(run.tokens, again.tokens)
    assert any("params=" in line for line in lines)
    # the same weights through the module-level path
    assert torch.equal(greedy_generate(run.model, run.batch, max_new_tokens=3), run.tokens)


@pytest.mark.parametrize("arch", MOE)
def test_run_serving_moe_on_the_cpu(arch):
    run = run_serving(arch=arch, batch=2, prompt_len=7, new_tokens=3, seed=2, device="cpu",
                      log=lambda *a: None)
    cfg = run.model.cfg
    assert cfg.moe and cfg.dtype == "float32" and run.tokens.shape == (2, 3)
    assert run.n_params == count_params(run.model) == count_params_abstract(
        jax_base.get_arch(arch).reduced())
    assert torch.equal(greedy_generate(run.model, run.batch, max_new_tokens=3), run.tokens)
