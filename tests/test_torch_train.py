"""The port's LM training path against the reference package, on the CPU
at the reduced qwen2.5-3b config in float32 (bfloat16 where a test says
so), and at the reduced configs of the two MoE architectures, whose
training routes at capacity and adds the load-balance loss (aux).

The reference initialises its parameters (or its whole TrainState);
``convert.tree_from_reference`` hands the same tree to the port, whose
training keeps the reference's stacked layout.  Tolerances: the loss 1e-6
relative and each leaf's gradient within 1e-5 of that leaf's max |g| (the
same float32 arithmetic, library kernels summing in other orders); the
12-step train trajectory 1e-5 relative a step on the loss and 1e-5
absolute on the final parameters; bfloat16 compute with float32
accumulation, whose roundings differ between XLA and PyTorch, within the
bounds that test states.  Within the port every remat policy's gradient
is bit-equal to no remat, and the data batches are bit-equal to the
reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.data.synthetic_lm import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as jax_tfm
from repro.models.zoo import active_params as jax_active_params
from repro.models.zoo import build_model as jax_build_model
from repro.models.zoo import count_params_abstract as jax_count_abstract
from repro.optim import adamw as jax_adamw
from repro.optim import cosine_with_warmup as jax_cosine
from repro.train.state import init_state as jax_init_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import base
from repro_torch.data.synthetic_lm import SyntheticLM
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import tree_from_reference
from repro_torch.models.zoo import active_params, build_model, count_params_abstract
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train.state import TrainState, init_state, state_specs
from repro_torch.train.step import REMAT_POLICIES, cast_params, make_train_step
from repro_torch.train.tree import leaves, leaves_with_paths

ARCH = "qwen2_5_3b"
DENSE_GQA = ["qwen2_5_3b", "qwen2_72b", "granite_3_8b", "internlm2_20b"]
MOE = ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]
AUX_RTOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5          # of each leaf's max |g|
TRAJ_LOSS_RTOL = 1e-5
TRAJ_PARAM_ATOL = 1e-5
# bfloat16 compute: XLA and PyTorch round the bf16 products and casts in
# other places.  Over 4 steps the losses agree within 1e-3 relative
# (measured 1.5e-4).  A gradient element near zero can take the other sign,
# and Adam then moves it by up to lr_t the other way each step: the float32
# masters agree within 2 * sum(lr_t) = 6e-4 over the 4 warmup steps
# (measured 4.8e-4, on embedding rows).
BF16_LOSS_RTOL = 1e-3
BF16_PARAM_ATOL = 2 * sum(3e-4 * (t + 1) / 10 for t in range(4))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, dtype="float32"):
    jcfg = dataclasses.replace(jax_base.get_arch(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(base.get_arch(arch).reduced(), dtype=dtype)
    return jcfg, tcfg


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _from_ref(tree):
    return tree_from_reference(jax.tree.map(np.asarray, tree))


def _state_from_ref(jstate) -> TrainState:
    return TrainState(step=torch.tensor(int(jstate.step), dtype=torch.int32),
                      params=_from_ref(jstate.params), opt_state=_from_ref(jstate.opt_state))


def _batch_pair(jcfg, tcfg, step, *, B=4, S=32, seed=0):
    jb = JaxSyntheticLM(jcfg, jax_base.ShapeConfig("t", S, B, "train"), seed=seed).batch_at(step)
    tb = SyntheticLM(tcfg, base.ShapeConfig("t", S, B, "train"), seed=seed,
                     device="cpu").batch_at(step)
    return jb, tb


def _grads_ref(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    jb, tb = _batch_pair(jcfg, tcfg, 3)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jb), has_aux=True)(jparams)
    return dict(tcfg=tcfg, params=jparams, batch=tb, loss=float(loss),
                aux=float(metrics["aux"]), grads=jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def grads_ref():
    """The reference's params, one batch, its loss and its gradients."""
    return _grads_ref(ARCH)


@pytest.fixture(scope="module", params=MOE)
def moe_grads_ref(request):
    """The same for an MoE config: the reference's training forward routes
    at capacity (dropless=False) and its loss carries 0.01 * aux."""
    return _grads_ref(request.param)


def _port_grads(ref, remat):
    model = build_model(ref["tcfg"], device="meta")
    params = _from_ref(ref["params"])
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.train_loss(params, ref["batch"], remat_policy=REMAT_POLICIES[remat])
    grads = torch.autograd.grad(loss, flat)
    names = [n for n, _ in leaves_with_paths(params)]
    return float(loss.detach()), metrics, dict(zip(names, grads))


def test_token_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 512)).astype(np.float32) * 3
    targets = rng.integers(0, 512, size=(2, 7)).astype(np.int32)
    want = float(jax_tfm.token_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(tfm.token_loss(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    # bf16 logits: the loss still runs in float32
    got16 = tfm.token_loss(torch.from_numpy(logits).to(torch.bfloat16),
                           torch.from_numpy(targets))
    assert got16.dtype == torch.float32


def _check_grads(ref, remat):
    """The loss, aux and every leaf's gradient against jax.grad of the
    reference's forward_train under ``remat``; each policy's gradients
    bit-equal to no remat."""
    loss, metrics, grads = _port_grads(ref, remat)
    assert loss == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    aux = float(metrics["aux"].detach())
    if ref["aux"] == 0.0:
        assert aux == 0.0
    else:
        assert aux == pytest.approx(ref["aux"], rel=AUX_RTOL)
    want = dict(jax.tree_util.tree_flatten_with_path(ref["grads"])[0])
    want = {jax.tree_util.keystr(k): v for k, v in want.items()}
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(_np(g), w, atol=GRAD_TOL * scale, rtol=0, err_msg=name)
    if remat != "none":
        _, _, plain = _port_grads(ref, "none")
        for name, g in grads.items():
            assert torch.equal(g, plain[name]), name


@pytest.mark.parametrize("remat", list(REMAT_POLICIES))
def test_forward_train_loss_and_grads(grads_ref, remat):
    """The dense config: aux is 0 in both packages."""
    assert grads_ref["aux"] == 0.0
    _check_grads(grads_ref, remat)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_moe_forward_train_loss_aux_and_grads(moe_grads_ref, remat):
    """The MoE configs at capacity: the loss, the layers' summed aux and
    every gradient (router, experts, shared experts, MLA) as the
    reference's, with and without remat; the remat'd layers carry their
    aux through checkpoint."""
    assert moe_grads_ref["aux"] > 0.0
    _check_grads(moe_grads_ref, remat)


def test_forward_train_makes_no_caches(monkeypatch):
    """forward_train goes around the prefill stack, which allocates the KV
    caches."""
    _, tcfg = _cfgs()
    net = tfm.DecoderLM(tcfg, device="cpu")
    net.init_params(0)

    def refuse(*a, **k):
        raise AssertionError("the training forward built KV caches")

    monkeypatch.setattr(tfm, "_run_decoder_stack", refuse)
    _, tb = _batch_pair(*_cfgs(), 0)
    loss, _ = tfm.forward_train(net, tb)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", DENSE_GQA + MOE)
def test_specs_and_param_counts(arch):
    """The specs tree equals the reference's init specs leaf for leaf; the
    parameter counts at full width equal the reference's."""
    jcfg, tcfg = _cfgs(arch)
    _, jspecs = jax_build_model(jcfg).init(jax.random.key(0))
    params, specs = tfm.init_params(tcfg, device="meta")
    assert specs == jspecs
    assert [n for n, _ in leaves_with_paths(params)] == [
        jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(lambda k: jax_tfm.init_params(k, jcfg)[0], jax.random.key(0)))[0]]
    assert state_specs(specs) == {"step": (), "params": specs,
                                  "opt_state": {"m": specs, "v": specs}}
    full_j, full_t = jax_base.get_arch(arch), base.get_arch(arch)
    assert count_params_abstract(full_t) == jax_count_abstract(full_j)
    assert active_params(full_t) == jax_active_params(full_j)


@pytest.mark.parametrize("arch,total,active", [
    ("deepseek_v2_lite_16b", 16_210_311_168, 2_663_233_536),
    ("qwen3_moe_30b_a3b", 30_532_634_624, 3_353_544_704),
])
def test_moe_counts_at_full_width(arch, total, active):
    """The reference's counts: every parameter, and the active ones (all
    but the routed experts, plus top_k experts a layer); the router is
    float32 in the tree whatever the config's dtype."""
    cfg = base.get_arch(arch)
    assert count_params_abstract(cfg) == total == jax_count_abstract(jax_base.get_arch(arch))
    assert active_params(cfg) == active == jax_active_params(jax_base.get_arch(arch))
    params, specs = tfm.init_params(cfg, device="meta")
    assert cfg.dtype == "bfloat16"
    assert params["layers"]["mlp"]["router"]["w"].dtype == torch.float32
    assert params["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert specs["layers"]["mlp"]["wi"] == ("layers", "expert", "embed", "mlp")
    assert specs["layers"]["mlp"]["router"]["w"] == ("layers", "embed", "expert")


def test_decoder_lm_defaults_to_the_card(monkeypatch):
    """DecoderLM(cfg) builds on cuda unless told otherwise, and without CUDA
    raises instead of falling back to the CPU."""
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.DecoderLM(tcfg)
    assert tfm.DecoderLM(tcfg, device="meta").device.type == "meta"


def test_init_params_distribution():
    """Zero biases, unit norm scales, and each matrix's std within 5 % of
    the reference's leaf (truncated normal at the same scale)."""
    jcfg, tcfg = _cfgs()
    jparams, _ = jax_build_model(jcfg).init(jax.random.key(0))
    params, _ = tfm.init_params(tcfg, seed=1, device="cpu")
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for name, p in leaves_with_paths(params):
        w = want[name]
        assert tuple(p.shape) == w.shape and p.dtype == torch.float32, name
        if name.endswith("['b']"):
            assert not p.any(), name
        elif name.endswith("['scale']"):
            assert (p == 1).all(), name
        else:
            assert float(p.std()) == pytest.approx(float(w.std()), rel=0.05), name
    # the same seed draws the same tree; the generator differs from JAX's
    again, _ = tfm.init_params(tcfg, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(again)))


def _ref_trajectory(jcfg, steps, microbatches, B=4, S=32):
    jmodel = jax_build_model(jcfg)
    jopt = jax_adamw(jax_cosine(3e-4, warmup=10, total=steps))
    jstate, _ = jax_init_state(jmodel, jopt, jax.random.key(0))
    start = _state_from_ref(jstate)
    step_fn = jax.jit(jax_make_train_step(jmodel, jopt, microbatches=microbatches,
                                          remat="none"))
    data = JaxSyntheticLM(jcfg, jax_base.ShapeConfig("t", S, B, "train"), seed=0)
    losses = []
    for i in range(steps):
        jstate, m = step_fn(jstate, data.batch_at(i))
        losses.append(float(m["loss"]))
    return start, losses, jstate


def _port_trajectory(tcfg, start, steps, microbatches, B=4, S=32):
    model = build_model(tcfg, device="meta")
    opt = adamw(cosine_with_warmup(3e-4, warmup=10, total=steps))
    step_fn = make_train_step(model, opt, microbatches=microbatches, remat="none")
    data = SyntheticLM(tcfg, base.ShapeConfig("t", S, B, "train"), seed=0, device="cpu")
    state, losses = start, []
    for i in range(steps):
        state, m = step_fn(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    return losses, state


def _check_trajectory(arch, steps, microbatches):
    jcfg, tcfg = _cfgs(arch)
    start, want_losses, jstate = _ref_trajectory(jcfg, steps, microbatches)
    losses, state = _port_trajectory(tcfg, start, steps, microbatches)
    np.testing.assert_allclose(losses, want_losses, rtol=TRAJ_LOSS_RTOL)
    assert int(state.step) == int(jstate.step) == steps
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for name, p in leaves_with_paths(state.params):
        np.testing.assert_allclose(_np(p), want[name], atol=TRAJ_PARAM_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_trajectory_matches_reference(microbatches):
    """12 steps of make_train_step from the reference's initial TrainState,
    on SyntheticLM batches of 4 x 32, AdamW on the cosine schedule."""
    _check_trajectory(ARCH, 12, microbatches)


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_step_trajectory_matches_reference(arch):
    """6 steps of the MoE configs at capacity, 2 microbatches: the losses
    (aux included) and the final parameters as the reference's."""
    _check_trajectory(arch, 6, 2)


def test_train_step_bf16_compute_f32_accumulation():
    """cfg.dtype bfloat16: the step computes in bf16 from float32 masters
    and accumulates float32 gradients (2 microbatches)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    start, want_losses, jstate = _ref_trajectory(jcfg, 4, 2)
    assert all(p.dtype == torch.float32 for p in leaves(start.params))
    losses, state = _port_trajectory(tcfg, start, 4, 2)
    np.testing.assert_allclose(losses, want_losses, rtol=BF16_LOSS_RTOL)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for name, p in leaves_with_paths(state.params):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(_np(p), want[name], atol=BF16_PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_cast_params_does_not_copy_float32():
    _, tcfg = _cfgs()
    params, _ = tfm.init_params(tcfg, device="cpu")
    same = cast_params(params, torch.float32)
    assert all(a is b for a, b in zip(leaves(params), leaves(same)))
    half = cast_params(params, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in leaves(half))


def test_init_state_master_is_the_stacked_float32_tree():
    _, tcfg = _cfgs(dtype="bfloat16")
    model = build_model(tcfg, device="meta")
    state, specs = init_state(model, adamw(), 0, device="cpu")
    L = tcfg.n_layers
    assert state.params["layers"]["ln1"]["scale"].shape == (L, tcfg.d_model)
    assert all(p.dtype == torch.float32 for p in leaves(state.params))
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert specs["layers"]["ln1"]["scale"] == ("layers", "embed")
    # nothing of the training net is allocated
    assert model.device.type == "meta"


def test_sharding_policy_is_not_ported():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="mesh slice"):
        make_train_step(build_model(tcfg, device="meta"), adamw(), sharding_policy=object())


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("step", [0, 17])
def test_synthetic_batches_bit_equal(seed, step):
    jcfg, tcfg = _cfgs()
    jb, tb = _batch_pair(jcfg, tcfg, step, seed=seed)
    assert set(jb) == set(tb) == {"tokens", "targets"}
    for k in jb:
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(_np(tb[k]), np.asarray(jb[k]))
    other = SyntheticLM(tcfg, base.ShapeConfig("t", 32, 4, "train"), seed=seed + 1,
                        device="cpu").batch_at(step)
    assert not torch.equal(other["tokens"], tb["tokens"])


def test_synthetic_prefetch_thread():
    _, tcfg = _cfgs()
    data = SyntheticLM(tcfg, base.ShapeConfig("t", 8, 2, "train"), seed=2, device="cpu")
    data.start(first_step=3)
    try:
        got = [data.next() for _ in range(2)]
    finally:
        data.stop()
    assert not data._thread.is_alive()
    for i, b in enumerate(got):
        assert torch.equal(b["tokens"], data.batch_at(3 + i)["tokens"])


def test_run_training_adafactor_raises_type_error_in_both():
    """The reference hands its schedule (a function) to adafactor, which
    multiplies by it; the port keeps that behaviour."""
    from repro.launch.train import run_training as jax_run_training
    from repro_torch.launch.train import run_training

    common = dict(arch=ARCH, steps=2, batch=2, seq=8, optimizer_name="adafactor",
                  log=lambda *a, **k: None)
    with pytest.raises(TypeError):
        jax_run_training(**common)
    with pytest.raises(TypeError):
        run_training(device="cpu", **common)


def test_run_training_defaults_to_cuda_and_never_falls_back(monkeypatch):
    from repro_torch.launch.train import run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(arch=ARCH, steps=1, batch=2, seq=8, log=lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(_cfgs()[1], base.ShapeConfig("t", 8, 2, "train"))
    state, losses, status = run_training(arch=ARCH, steps=2, batch=2, seq=8, device="cpu",
                                         log=lambda *a: None)
    assert status == "done" and len(losses) == 2 and int(state.step) == 2
    assert state.params["embed"]["table"].device.type == "cpu"
