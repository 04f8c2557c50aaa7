"""The port's optimizers against the reference's: the reference's own
optimizer cases (convergence on a convex problem, decoupled decay, the
clip, Adafactor's factored state, the schedule's shape) run on the port,
then one AdamW and one Adafactor update of the reduced qwen2.5-3b stacked
tree from the same gradients and state, held to the reference's within
1e-7 absolute plus one float32 rounding of the value (the clip engaged,
the stacked (L, d) norm leaves factored across the layers), and the
schedule within one float32 rounding of its peak.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models.zoo import build_model as jax_build_model
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import cosine_with_warmup as jax_cosine
from repro_torch.models.convert import tree_from_reference
from repro_torch.optim import OPTIMIZERS, adafactor, adamw, cosine_with_warmup
from repro_torch.train.tree import leaves, leaves_with_paths, tree_map

# XLA orders and fuses the last products of an update (lr * (m_hat / den +
# wd * p), then p minus that) otherwise than the in-place leaf loop does:
# the results differ by one rounding of the parameter, 1.19e-7 measured on
# embedding entries in [1, 2).  So 1e-7 absolute plus one float32 ulp of the
# value (2**-23 relative).
UPDATE_ATOL = 1e-7
UPDATE_RTOL = 2.0**-23


def _quadratic(params):
    w = params["w"]
    return torch.sum((w - 3.0) ** 2)


@pytest.mark.parametrize("make_opt", [lambda: adamw(1e-1, weight_decay=0.0),
                                      lambda: adafactor(5e-1)], ids=["adamw", "adafactor"])
def test_converges_on_convex(make_opt):
    opt = make_opt()
    params = {"w": torch.zeros((4, 4))}
    state = opt.init(params)
    for i in range(400):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_quadratic({"w": w}), [w])
        with torch.no_grad():
            params, state = opt.update({"w": g}, state, params, torch.tensor(i))
    assert float(_quadratic(params)) < 1e-2  # optimum is 0 at w == 3


def test_adamw_weight_decay_decoupled():
    opt = adamw(1e-2, weight_decay=0.5, grad_clip=0.0)
    params = {"w": torch.ones((3,))}
    state = opt.init(params)
    zero_g = {"w": torch.zeros((3,))}
    new_params, _ = opt.update(zero_g, state, params, torch.tensor(0))
    # pure decay: w <- w - lr*wd*w
    np.testing.assert_allclose(new_params["w"].numpy(), 1.0 - 1e-2 * 0.5, rtol=1e-6)


def test_grad_clip():
    opt = adamw(1e-3, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((2,))}
    state = opt.init(params)
    big = {"w": torch.full((2,), 1e6)}
    p1, _ = opt.update(big, state, params, torch.tensor(0))
    assert torch.isfinite(p1["w"]).all()


def test_adafactor_state_is_factored():
    opt = adafactor()
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,))}
    state = opt.init(params)
    assert state["w"]["vr"].shape == (64,)
    assert state["w"]["vc"].shape == (32,)
    assert state["b"]["v"].shape == (32,)
    n_state = sum(leaf.numel() for leaf in leaves(state))
    n_adam = 2 * sum(leaf.numel() for leaf in leaves(params))
    assert n_state < 0.1 * n_adam


def test_cosine_schedule_shape():
    lr = cosine_with_warmup(1.0, warmup=10, total=100, floor=0.1)
    assert float(lr(0)) < float(lr(9)) <= 1.0
    np.testing.assert_allclose(float(lr(10)), 1.0, rtol=1e-5)
    assert float(lr(99)) < 0.2
    assert float(lr(99)) >= 0.1 * 0.99


def test_cosine_schedule_matches_reference():
    """float32 arithmetic on a float32 step, as the reference's.  cos may
    differ in its last bit between the libraries, and near the end of the
    decay 1 + cos cancels, so the bound is one float32 rounding of the peak
    (measured: 1.1e-11 at peak 3e-4, step 171 of 200)."""
    for peak, warmup, total in ((3e-4, 10, 12), (3e-4, 10, 200), (1.0, 7, 50)):
        ref, lr = jax_cosine(peak, warmup=warmup, total=total), cosine_with_warmup(
            peak, warmup=warmup, total=total)
        for step in range(total + 3):
            got = lr(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            want = np.float32(ref(jnp.asarray(step, jnp.int32)))
            assert abs(float(got) - float(want)) <= peak * 2.0**-23, (step, got, want)


@pytest.fixture(scope="module")
def stacked_tree():
    """The reduced qwen2.5-3b parameter tree (stacked layers) and two
    gradient trees whose global norms engage the clip."""
    cfg = dataclasses.replace(jax_base.get_arch("qwen2_5_3b").reduced(), dtype="float32")
    params, _ = jax_build_model(cfg).init(jax.random.key(0))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * s).astype(np.float32),
                          params) for s in (0.3, 0.05)]
    return params, grads


def _torch(tree):
    return tree_from_reference(tree)


def _check_update(jopt, opt, params, grads):
    """Two updates from the optimizers' initial states (the second from a
    nonzero state): parameters and state within UPDATE_ATOL."""
    jp, js = jax.tree.map(jnp.asarray, params), None
    tp = _torch(params)
    js, ts = jopt.init(jp), opt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(step, jnp.int32))
        tp, ts = opt.update(_torch(g), ts, tp, torch.tensor(step, dtype=torch.int32))
        for want_tree, got_tree in ((jp, tp), (js, ts)):
            want = {jax.tree_util.keystr(k): np.asarray(v)
                    for k, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
            got = dict(leaves_with_paths(got_tree))
            assert set(want) == set(got)
            for name, w in want.items():
                np.testing.assert_allclose(got[name].numpy(), w, atol=UPDATE_ATOL,
                                           rtol=UPDATE_RTOL,
                                           err_msg=f"step {step} {name}")
    return ts


def test_adamw_update_matches_reference(stacked_tree):
    params, grads = stacked_tree
    gnorm = np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree.leaves(grads[0])))
    assert gnorm > 1.0  # the clip engages
    sched = (jax_cosine(3e-4, warmup=10, total=20), cosine_with_warmup(3e-4, warmup=10,
                                                                      total=20))
    _check_update(jax_adamw(sched[0]), adamw(sched[1]), params, grads)
    _check_update(jax_adamw(1e-2, weight_decay=0.3), adamw(1e-2, weight_decay=0.3), params,
                  grads)


def test_adafactor_update_matches_reference(stacked_tree):
    params, grads = stacked_tree
    ts = _check_update(jax_adafactor(1e-2, weight_decay=0.1), adafactor(1e-2, weight_decay=0.1),
                       params, grads)
    # a stacked (L, d) norm leaf is factored across its layers
    L, d = params["layers"]["ln1"]["scale"].shape
    assert ts["layers"]["ln1"]["scale"]["vr"].shape == (L,)
    assert ts["layers"]["ln1"]["scale"]["vc"].shape == (d,)


def test_update_is_in_place(stacked_tree):
    """AdamW writes the parameters and state where they lie (no second tree
    at full width)."""
    params, grads = stacked_tree
    opt = OPTIMIZERS["adamw"](1e-3)
    tp = _torch(params)
    ts = opt.init(tp)
    ptrs = [t.data_ptr() for t in leaves(tp) + leaves(ts)]
    new_p, new_s = opt.update(_torch(grads[0]), ts, tp, torch.tensor(0))
    assert [t.data_ptr() for t in leaves(new_p) + leaves(new_s)] == ptrs
    before = tree_map(torch.clone, new_p)
    opt.update(_torch(grads[1]), new_s, new_p, torch.tensor(1))
    assert not torch.equal(before["lm_head"]["w"], new_p["lm_head"]["w"])
