"""Fault tolerance of the port, after the reference's
``tests/test_fault_tolerance.py``: checkpoint roundtrip, the LATEST
pointer and retention, a torn save invisible, bit-exact restart through
``run_training``, restore onto other devices, data determinism and int8
compression with error feedback; then a checkpoint the reference saves
restored by the port, a save taken while the next update runs, a SIGTERM
preemption, and ``compressed_psum`` over four CPU parts against the
reference's per-part quantization.  Restart and the saves compare bit for
bit; the compression within the reference's bounds.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.io import latest_step
from repro_torch.train.tree import leaves, leaves_with_paths

ARCH = "qwen2_5_3b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "step": torch.tensor(7, dtype=torch.int32),
        "params": {"w": torch.randn((8, 16), generator=g), "b": torch.zeros((16,))},
        "opt": {"m": torch.ones((8, 16)) * 0.5, "h": torch.ones(4, dtype=torch.bfloat16)},
    }


def _equal_trees(a, b):
    na, nb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    assert [n for n, _ in na] == [n for n, _ in nb]
    for (name, x), (_, y) in zip(na, nb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_roundtrip(tmp_path):
    state = small_state()
    save_checkpoint(tmp_path, 7, state)
    restored, step = restore_checkpoint(tmp_path, state)
    assert step == 7
    _equal_trees(state, restored)


def test_latest_pointer_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, every=1, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, small_state(s))
    assert latest_step(tmp_path) == 4
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 2 and kept[-1] == "step_000000004"


def test_atomicity_partial_save_invisible(tmp_path):
    """A torn checkpoint directory without the LATEST pointer swap is
    ignored by restore."""
    state = small_state()
    save_checkpoint(tmp_path, 1, state)
    torn = tmp_path / "step_000000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{not json")
    _, step = restore_checkpoint(tmp_path, state)
    assert step == 1


def test_bit_exact_restart(tmp_path):
    """12 steps straight against 6, a checkpoint, a resume and 6 more: the
    final parameters and optimizer state bit-equal (deterministic data and
    optimizer), with PyTorch's deterministic algorithms enforced."""
    from repro_torch.launch.train import run_training

    common = dict(arch=ARCH, batch=4, seq=32, reduced=True, ckpt_every=6,
                  log=lambda *a, **k: None, device="cpu")
    torch.use_deterministic_algorithms(True)
    try:
        state_a, losses_a, _ = run_training(steps=12, ckpt_dir=None, **common)
        d1 = tmp_path / "run"
        _, losses_b1, _ = run_training(steps=6, ckpt_dir=str(d1), **common)
        state_b2, losses_b2, _ = run_training(steps=12, ckpt_dir=str(d1), resume=True,
                                              **common)
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(state_a.step) == int(state_b2.step) == 12
    assert losses_a == losses_b1 + losses_b2
    _equal_trees(state_a, state_b2)


def test_restore_onto_other_devices(tmp_path):
    """The saved layout does not bind the restore: every leaf goes to the
    device the caller names, one device or a tree of them (here the CPU and
    the meta device, the devices a CPU test has)."""
    state = small_state()
    save_checkpoint(tmp_path, 3, state, mesh_shape=(16, 16))
    restored, step = restore_checkpoint(tmp_path, state, device="cpu")
    assert step == 3
    _equal_trees(state, restored)
    devices = {"step": "cpu", "params": {"w": "meta", "b": "cpu"},
               "opt": {"m": torch.device("meta"), "h": "cpu"}}
    placed, _ = restore_checkpoint(tmp_path, state, device=devices)
    for (name, leaf), (_, dev) in zip(leaves_with_paths(placed), leaves_with_paths(devices)):
        assert leaf.device == torch.device(dev), name
    assert torch.equal(placed["params"]["b"], state["params"]["b"])


def test_data_pipeline_determinism():
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.data.synthetic_lm import SyntheticLM

    cfg = get_arch("granite_3_8b").reduced()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    a = SyntheticLM(cfg, shape, seed=3, device="cpu").batch_at(17)
    b = SyntheticLM(cfg, shape, seed=3, device="cpu").batch_at(17)
    for k in a:
        assert torch.equal(a[k], b[k])
    c = SyntheticLM(cfg, shape, seed=4, device="cpu").batch_at(17)
    assert not torch.equal(a["tokens"], c["tokens"])


def test_grad_compression_roundtrip():
    from repro_torch.optim.grad_compress import compress_tree, dequantize_int8, quantize_int8

    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.standard_normal((64, 64)) * 0.01).astype(np.float32))
    q, scale = quantize_int8(g)
    assert q.dtype == torch.int8
    deq = dequantize_int8(q, scale)
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-9

    # error feedback drives the *accumulated* bias to zero over steps
    grads = {"w": g}
    err = None
    acc_true = torch.zeros_like(g)
    acc_comp = torch.zeros_like(g)
    for _ in range(50):
        deq_tree, err = compress_tree(grads, err)
        acc_true += g
        acc_comp += deq_tree["w"]
    resid = float((acc_comp - acc_true).abs().max())
    assert resid <= float(scale) * 1.5, resid


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference saves its TrainState; the port's TrainState of the same
    config restores it leaf for leaf, bit for bit."""
    from repro.checkpoint import save_checkpoint as jax_save
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models.zoo import build_model as jax_build_model
    from repro.optim import adamw as jax_adamw
    from repro.train.state import init_state as jax_init_state
    from repro_torch.configs.base import get_arch
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.state import TrainState, init_state

    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), dtype="float32")
    jstate, _ = jax_init_state(jax_build_model(jcfg), jax_adamw(), jax.random.key(4))
    jstate = dataclasses.replace(jstate, step=jnp.asarray(5, jnp.int32))
    jax_save(tmp_path, 5, jstate)

    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    like, _ = init_state(build_model(cfg, device="meta"), adamw(), 0, device="cpu")
    restored, step = restore_checkpoint(tmp_path, like)
    assert step == 5 and isinstance(restored, TrainState) and int(restored.step) == 5
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got = dict(leaves_with_paths(restored))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_async_save_is_not_torn_by_the_next_update(tmp_path):
    """An asynchronous save snapshots the state before its thread starts:
    the in-place update that follows cannot reach the saved values."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    model = build_model(cfg, device="meta")
    opt = adamw(1e-2)
    state, _ = init_state(model, opt, 0, device="cpu")
    step = make_train_step(model, opt, remat="none")
    data = SyntheticLM(cfg, ShapeConfig("t", 16, 2, "train"), device="cpu")
    state, _ = step(state, data.batch_at(0))
    saved = [t.clone() for t in leaves(state)]
    mgr = CheckpointManager(tmp_path, every=1)
    mgr.save(int(state.step), state)
    for i in range(1, 3):
        state, _ = step(state, data.batch_at(i))  # writes the same tensors in place
    mgr.wait()
    assert not torch.equal(saved[2], leaves(state)[2])
    restored, s = mgr.restore_latest(state)
    assert s == 1
    for a, b in zip(saved, leaves(restored)):
        assert torch.equal(a, b)


def test_sigterm_preempts_with_a_checkpoint(tmp_path):
    """SIGTERM sent from a step's log line: the run saves synchronously,
    returns "preempted", and the previous handlers are back."""
    from repro_torch.launch.train import run_training

    sent = []

    def log(msg):
        if msg.startswith("step") and not sent:
            sent.append(msg)
            os.kill(os.getpid(), signal.SIGTERM)

    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    state, losses, status = run_training(arch=ARCH, steps=30, batch=2, seq=8,
                                         ckpt_dir=str(tmp_path), ckpt_every=50, log=log,
                                         device="cpu")
    assert sent and status == "preempted"
    assert len(losses) == 1 and int(state.step) == 1
    assert latest_step(tmp_path) == 1
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    restored, _ = restore_checkpoint(tmp_path, state)
    _equal_trees(state, restored)


def test_compressed_psum_matches_reference_parts():
    """Four CPU parts with error feedback: the mean equals the mean of the
    reference's per-part dequantize(quantize(x + e)), and each new residual
    its x + e - that."""
    from repro.optim.grad_compress import dequantize_int8 as jax_deq
    from repro.optim.grad_compress import quantize_int8 as jax_q
    from repro_torch.optim.grad_compress import compressed_psum

    rng = np.random.default_rng(1)
    xs = [(rng.standard_normal((32, 16)) * 10.0 ** -k).astype(np.float32) for k in range(4)]
    es = [(rng.standard_normal((32, 16)) * 1e-3).astype(np.float32) for _ in range(4)]
    parts = [torch.from_numpy(x).to("cpu") for x in xs]
    mean, errors = compressed_psum(parts, errors=[torch.from_numpy(e) for e in es])
    deq = [np.asarray(jax_deq(*jax_q(jnp.asarray(x + e)))) for x, e in zip(xs, es)]
    np.testing.assert_allclose(mean.numpy(), np.mean(deq, axis=0), rtol=1e-6, atol=1e-9)
    for x, e, d, got in zip(xs, es, deq, errors):
        np.testing.assert_array_equal(got.numpy(), (x + e) - d)
    mean0, _ = compressed_psum(parts)
    assert mean0.shape == (32, 16) and mean0.dtype == torch.float32
