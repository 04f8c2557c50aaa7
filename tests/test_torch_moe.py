"""The port's MoE FFN and MLA attention against the reference package, on
the CPU at small widths with explicit seeds.

The reference draws its parameters (``moe_init`` / ``mla_init``) and the
port's modules load them (``params_from_reference``); inputs are numpy
arrays from ``default_rng``.  The two packages must choose the same
experts and keep the same (token, choice) pairs; the reference's keep
mask is recomputed here by its own one-hot cumsum.  Tolerances: float32
outputs 2e-6 (the same float32 products; the reference sums each expert's
rows through one-hot einsums, the port through per-expert matmuls) and aux
1e-6 relative; bfloat16 outputs within 1e-2 of max|out| (both round the
expert products to bf16, the combine's roundings differ: ~1 bf16 ulp);
MLA 2e-5 (a few float32 products deep, as tests/test_torch_lm.py's
attention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch.models import attention, moe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import rope_angles

D, E, K, F = 16, 8, 2, 12
TOL = 2e-6
AUX_RTOL = 1e-6
BF16_RTOL = 1e-2
MLA_TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _moe_pair(dtype, *, n_shared=1, zero_router=False, seed=0):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    p, _ = jax_moe.moe_init(jax.random.key(seed), D, n_experts=E, d_ff_expert=F, top_k=K,
                            n_shared=n_shared, d_ff_shared=F, dtype=jd)
    if zero_router:
        p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    assert p["router"]["w"].dtype == jnp.float32
    mod = moe.MoE(D, n_experts=E, d_ff_expert=F, n_shared=n_shared, d_ff_shared=F,
                  dtype=dtype, device="cpu")
    mod.load_state_dict(params_from_reference(jax.tree.map(np.asarray, p)))
    assert mod.router.w.dtype == torch.float32 and mod.wi.dtype == dtype
    return p, mod


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    return jnp.asarray(_np(tx), jnp.float32 if dtype == torch.float32 else jnp.bfloat16), tx


def _reference_routing(p, x, *, chunk, cf, dropless):
    """The reference's expert choices and keep mask, by its own formula
    (moe.py: softmax, lax.top_k, the one-hot cumsum), per padded pair."""
    B, S, _ = x.shape
    T = B * S
    Tc = min(chunk, T)
    xt = x.reshape(T, D)
    pad = (-T) % Tc
    xt = jnp.concatenate([xt, jnp.zeros((pad, D), xt.dtype)])
    nc = xt.shape[0] // Tc
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    C = Tc if dropless else int(min(Tc, max(1, (Tc * K * cf) // E)))
    onehot = jax.nn.one_hot(idx.reshape(nc, Tc, K), E, dtype=jnp.int32)
    flat = onehot.reshape(nc, Tc * K, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(nc, Tc, K, E) * onehot, -1)
    return np.asarray(idx), np.asarray(pos < C).reshape(-1), nc, C


def _port_routing(mod, tx, *, chunk, cf, dropless):
    B, S, _ = tx.shape
    T = B * S
    Tc = min(chunk, T)
    xt = torch.cat([tx.reshape(T, D), tx.new_zeros(((-T) % Tc, D))])
    _, _, idx = moe.route(mod, xt, top_k=K)
    nc = xt.shape[0] // Tc
    C = moe.capacity(Tc, n_experts=E, top_k=K, capacity_factor=cf, dropless=dropless)
    kept, counts = moe.kept_pairs(idx, n_chunks=nc, n_experts=E, cap=C)
    keep = torch.zeros(idx.numel(), dtype=torch.bool)
    keep[kept] = True
    # grouped by expert, in ascending pair order within each expert's chunk
    experts = idx.reshape(-1)[kept]
    assert torch.equal(experts, torch.sort(experts, stable=True).values)
    assert counts == torch.bincount(experts, minlength=E).tolist()
    return idx.numpy(), keep.numpy()


CASES = [
    # (label, batch shape, chunk, dropless): chunk < T, so the last chunk pads
    ("dropless", (2, 13), 8, True),
    ("capacity", (2, 13), 8, False),
    ("capacity_one_chunk", (3, 7), 1024, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,shape,chunk,dropless", CASES)
def test_moe_apply_matches_the_reference(label, shape, chunk, dropless, dtype):
    p, mod = _moe_pair(dtype)
    jx, tx = _x(shape + (D,), dtype)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25, dropless=dropless, chunk=chunk)
    want, want_aux = jax_moe.moe_apply(p, jx, **kw)
    got, aux = moe.moe_apply(mod, tx, **kw)
    assert got.dtype == dtype and got.shape == tx.shape and aux.dtype == torch.float32

    ridx, rkeep, _, C = _reference_routing(p, jx, chunk=chunk, cf=1.25, dropless=dropless)
    idx, keep = _port_routing(mod, tx, chunk=chunk, cf=1.25, dropless=dropless)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(keep, rkeep)
    if dropless:
        assert keep.all()
    elif label == "capacity":
        assert not keep.all(), f"no pair dropped at C = {C}"

    assert float(aux) == pytest.approx(float(want_aux), rel=AUX_RTOL)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    else:
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_RTOL * scale, rtol=0)


@pytest.mark.parametrize("dropless", [True, False])
def test_exact_ties_pick_the_lower_experts(dropless):
    """A zero router gives every expert the same probability: both packages
    pick experts 0..k-1 for every token (lax.top_k's tie rule), and at
    capacity both drop the same pairs."""
    p, mod = _moe_pair(torch.float32, zero_router=True)
    jx, tx = _x((2, 9, D), torch.float32, seed=3)
    kw = dict(n_experts=E, top_k=K, dropless=dropless, chunk=8)
    idx, keep = _port_routing(mod, tx, chunk=8, cf=1.25, dropless=dropless)
    assert (idx == np.arange(K)[None]).all()
    ridx, rkeep, _, _ = _reference_routing(p, jx, chunk=8, cf=1.25, dropless=dropless)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(keep, rkeep)
    assert keep.all() == dropless
    want, want_aux = jax_moe.moe_apply(p, jx, **kw)
    got, aux = moe.moe_apply(mod, tx, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=AUX_RTOL)


def test_top_k_stable_orders_ties_by_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1]])
    vals, idx = moe.top_k_stable(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_without_shared_experts_and_its_gradients():
    """qwen3-moe's shape (no shared expert); the loss gradient of out and
    aux reaches the router, every routed expert that got a row, and no
    expert that got none."""
    p, mod = _moe_pair(torch.float32, n_shared=0, seed=4)
    assert mod.shared is None and "shared" not in p
    jx, tx = _x((2, 5, D), torch.float32, seed=5)
    kw = dict(n_experts=E, top_k=K, dropless=False, chunk=4)

    def jloss(pp):
        out, aux = jax_moe.moe_apply(pp, jx, **kw)
        return jnp.sum(out**2) + aux

    jgrads = jax.grad(jloss)(p)
    params = dict(mod.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    out, aux = moe.moe_apply(mod, tx, **kw)
    grads = torch.autograd.grad(torch.sum(out**2) + aux, list(params.values()))
    for (name, _), g in zip(params.items(), grads):
        w = np.asarray(jgrads["router"]["w"] if name == "router.w" else jgrads[name])
        np.testing.assert_allclose(_np(g), w, atol=1e-5 * float(np.abs(w).max()), rtol=0,
                                   err_msg=name)


# ----------------------------------------------------------------------- MLA
H, LORA, NOPE, ROPE, VD = 4, 24, 8, 4, 6


@pytest.fixture(scope="module")
def mla():
    p, _ = jax_attn.mla_init(jax.random.key(9), 32, H, jnp.float32, kv_lora=LORA,
                             qk_nope_dim=NOPE, qk_rope_dim=ROPE, v_dim=VD)
    mod = attention.mla_init(32, H, kv_lora=LORA, qk_nope_dim=NOPE, qk_rope_dim=ROPE,
                             v_dim=VD, dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    mod.load_state_dict(params_from_reference(jax.tree.map(np.asarray, p)))
    return p, mod, dict(n_heads=H, kv_lora=LORA, qk_nope_dim=NOPE, qk_rope_dim=ROPE, v_dim=VD)


@pytest.mark.parametrize("mode", ["causal", "full"])
def test_mla_prefill_matches_the_reference(mla, mode):
    p, mod, dims = mla
    x = np.random.default_rng(12).standard_normal((2, 11, 32)).astype(np.float32)
    cos, sin = jax_layers.rope_angles(jnp.arange(11), ROPE, 1e6)
    want, wcache = jax_attn.mla_apply(p, jnp.asarray(x), cos=cos, sin=sin, mode=mode, **dims)
    got, gcache = attention.mla_apply(mod, torch.from_numpy(x), cos=torch.from_numpy(
        np.array(cos)), sin=torch.from_numpy(np.array(sin)), mode=mode, **dims)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MLA_TOL, rtol=MLA_TOL)
    assert set(gcache) == set(wcache) == {"c", "kr"}
    for name in ("c", "kr"):
        np.testing.assert_allclose(_np(gcache[name]), np.asarray(wcache[name]),
                                   atol=MLA_TOL, rtol=MLA_TOL)


def test_mla_chunked_prefill_matches_the_dense_form(mla, monkeypatch):
    """Above ATTN_CHUNK_THRESHOLD the q-chunked form runs, with q/k and v of
    different widths."""
    p, mod, dims = mla
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((1, 21, 32))
                         .astype(np.float32))
    cos, sin = rope_angles(torch.arange(21), ROPE, 1e6)
    dense, _ = attention.mla_apply(mod, x, cos=cos, sin=sin, **dims)
    monkeypatch.setattr(attention, "ATTN_CHUNK_THRESHOLD", 4)
    monkeypatch.setattr(attention, "ATTN_Q_CHUNK", 8)
    chunked, _ = attention.mla_apply(mod, x, cos=cos, sin=sin, **dims)
    np.testing.assert_allclose(_np(chunked), _np(dense), atol=MLA_TOL, rtol=MLA_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_matches_the_reference_and_writes_in_place(mla, dtype):
    """bfloat16: the port rounds the scores to bf16 before the softmax (its
    products run in the cache's dtype), the reference keeps them in float32;
    within 1e-2 of max|out|, as the MoE's bf16 outputs."""
    p, mod, dims = mla
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if dtype != torch.float32:
        p = jax.tree.map(lambda a: a.astype(jd), p)
        mod = attention.mla_init(32, H, kv_lora=LORA, qk_nope_dim=NOPE, qk_rope_dim=ROPE,
                                 v_dim=VD, dtype=dtype, device="cpu")
        mod.load_state_dict(params_from_reference(jax.tree.map(np.asarray, p)))
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    c = rng.standard_normal((2, 9, LORA)).astype(np.float32)
    kr = rng.standard_normal((2, 9, ROPE)).astype(np.float32)
    pos = 5
    c[:, pos + 1:] = 0.0
    kr[:, pos + 1:] = 0.0
    cos, sin = jax_layers.rope_angles(jnp.asarray([pos]), ROPE, 1e6)
    want, wcache = jax_attn.mla_apply(
        p, jnp.asarray(x, jd), cos=cos, sin=sin, mode="decode",
        pos=jnp.asarray(pos, jnp.int32), cache={"c": jnp.asarray(c, jd), "kr": jnp.asarray(kr, jd)},
        **dims)
    tcache = {"c": torch.from_numpy(c.copy()).to(dtype),
              "kr": torch.from_numpy(kr.copy()).to(dtype)}
    got, gcache = attention.mla_apply(
        mod, torch.from_numpy(x).to(dtype), cos=torch.from_numpy(np.array(cos)),
        sin=torch.from_numpy(np.array(sin)), mode="decode", pos=pos, cache=tcache, **dims)
    assert got.dtype == dtype
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, atol=MLA_TOL, rtol=MLA_TOL)
    else:
        np.testing.assert_allclose(_np(got.float()), want, atol=1e-2 * float(np.abs(want).max()),
                                   rtol=0)
    for name in ("c", "kr"):
        assert gcache[name] is tcache[name]
        np.testing.assert_allclose(_np(gcache[name].float()),
                                   np.asarray(wcache[name], np.float32),
                                   atol=MLA_TOL if dtype == torch.float32 else 1e-2,
                                   rtol=MLA_TOL if dtype == torch.float32 else 1e-2)
    np.testing.assert_array_equal(_np(gcache["c"][:, :pos].float()),
                                  np.asarray(jnp.asarray(c[:, :pos], jd), np.float32))
