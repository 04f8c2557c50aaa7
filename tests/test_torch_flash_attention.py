"""The ``flash_attention`` kernel's plain version against the reference
package: its Pallas kernel (``repro.kernels.flash_attention``, run in
interpret mode off the TPU, as ``tests/test_kernels.py`` runs it) and its
oracle ``attention_ref``; the port's head-dim padding (the card runs a
d off its instances on the next one, with zero columns), head dims above
256 (the wide instances); and the port's wrapper's dispatch.

Inputs come from ``np.random.default_rng`` and reach both packages as the
same float32 values (rounded once to bf16 for the bf16 cases).
Tolerances: the reference's own for its kernel, 2e-5 in float32 (the two
sum the same float32 products in other orders, the kernel with an online
softmax) and 3e-2 in bf16 (outputs rounded to bf16 after float32 sums that
differ in order); the port's plain version against the reference's oracle,
which computes the same materialized float32 softmax, within 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, pad_head_dim
from repro_torch.kernels.flash_attention.ops import instance_head_dim

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ORACLE_TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Hq, Hkv, Sq, Skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]


def _both(arrays, dtype):
    torch_in = [torch.from_numpy(a).to(dtype) for a in arrays]
    jax_in = [jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays]
    return torch_in, jax_in


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the reference's grid (tests/test_kernels.py) plus head_dim 4, a ragged
# square length and a ragged causal cross length
SHAPES = [
    (1, 4, 4, 64, 64, 16),    # MHA square
    (2, 8, 2, 32, 32, 8),     # GQA 4:1
    (1, 4, 1, 40, 72, 16),    # MQA, ragged + cross lengths
    (2, 4, 2, 50, 50, 4),     # head_dim 4, ragged square
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, Hq, Hkv, Sq, Skv, d, causal, dtype):
    (q, k, v), (jq, jk, jv) = _both(_inputs(0, B, Hq, Hkv, Sq, Skv, d), dtype)
    got = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    kernel = jax_flash(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=TOL[dtype], rtol=TOL[dtype])
    tol = ORACLE_TOL if dtype == torch.float32 else TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_reference_kernel_random_shapes(seed):
    """The reference's property test, over fixed seeds: causal, GQA group
    1, 2 or 4, head dims 4 to 16, lengths 2 to 48, its 8 x 8 blocks."""
    rng = np.random.default_rng(100 + seed)
    sq = int(rng.integers(2, 49))
    d = int(rng.choice([4, 8, 16]))
    group = int(rng.choice([1, 2, 4]))
    (q, k, v), (jq, jk, jv) = _both(_inputs(seed, 1, 2 * group, 2, sq, sq, d), torch.float32)
    got = attention_ref(q, k, v, causal=True)
    kernel = jax_flash(jq, jk, jv, causal=True, block_q=8, block_k=8)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


def _wgmma_arithmetic(q, k, v, *, causal, scale=None, tile=64):
    """The card's bf16 wgmma body in plain torch: float32 scores of bf16
    inputs, an online softmax over 64-key tiles in base 2, P rounded to
    bf16 before P V, float32 sums, the output rounded to bf16."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1:3]
    scale = d**-0.5 if scale is None else scale
    qf = q.float()
    kf, vf = (torch.repeat_interleave(x, Hq // Hkv, dim=1).float() for x in (k, v))
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, d))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, tile):
        kpos = torch.arange(k0, min(k0 + tile, Skv))[None, :]
        s = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * (scale * 1.4426950408889634)
        if causal:
            s = s.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d", SHAPES + [(1, 2, 1, 129, 65, 64)])
def test_bf16_p_rounding_stays_within_the_reference_tolerance(B, Hq, Hkv, Sq, Skv, d, causal):
    """Rounding P to bf16 before P V (the wgmma body's A operand) keeps the
    bf16 output within the reference's own 3e-2 of its oracle."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(5, B, Hq, Hkv, Sq, Skv, d), torch.bfloat16)
    got = _wgmma_arithmetic(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    oracle = jax_attention_ref(jq, jk, jv, causal=causal)
    tol = TOL[torch.bfloat16]
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


def test_explicit_scale_matches_the_reference():
    (q, k, v), (jq, jk, jv) = _both(_inputs(3, 1, 4, 2, 24, 24, 8), torch.float32)
    got = flash_attention(q, k, v, causal=True, scale=0.3)
    want = jax_attention_ref(jq, jk, jv, causal=True, scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ORACLE_TOL, rtol=ORACLE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_the_cpu_is_the_plain_version(dtype):
    (q, k, v), _ = _both(_inputs(4, 2, 8, 2, 33, 33, 16), dtype)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        assert torch.equal(got, attention_ref(q, k, v, causal=causal))
        assert got.dtype == dtype


def test_wrapper_asserts_grouped_heads_and_rejects_other_devices():
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 3, 8, 16))
    with pytest.raises(AssertionError, match="multiple of Hkv"):
        flash_attention(q, kv, kv)
    m = torch.zeros((1, 4, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(m, m, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [4, 12, 80, 96, 192])
def test_padded_head_dim_matches_reference_kernel(d, causal, dtype):
    """The card runs d off its instances padded with zero columns to the
    next one, at the unpadded d's scale: the plain version on the padded
    tensors, sliced back, against the reference's kernel at d itself (GQA,
    ragged cross lengths).  The padded output columns are exactly zero.
    (float32 d = 96, and d = 192 in both dtypes, DeepSeek-V2's query-key
    width, have instances of their own: their padding is none.)"""
    (q, k, v), (jq, jk, jv) = _both(_inputs(7, 1, 4, 2, 40, 56, d), dtype)
    to = instance_head_dim(d, dtype)
    qp, kp, vp = pad_head_dim(q, k, v, to)
    assert qp.shape == (1, 4, 40, to) and kp.shape == vp.shape == (1, 2, 56, to)
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    out = attention_ref(qp, kp, vp, causal=causal, scale=d**-0.5)
    assert not out[..., d:].any()
    got = out[..., :d]
    kernel = jax_flash(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=TOL[dtype], rtol=TOL[dtype])


def test_instance_head_dims():
    """Each dtype's body runs d on its smallest instance at or above d, and
    above 256 on its wide instance at d rounded up to a multiple of 4
    (float32) or 8 (bf16); d < 1 raises."""
    want = {1: (32, 16), 4: (32, 16), 12: (32, 16), 16: (32, 16), 17: (32, 32),
            32: (32, 32), 33: (64, 64), 64: (64, 64), 80: (96, 128), 96: (96, 128),
            97: (128, 128), 128: (128, 128), 129: (160, 192), 160: (160, 192),
            161: (192, 192), 192: (192, 192), 193: (256, 256), 256: (256, 256),
            257: (260, 264), 260: (260, 264), 320: (320, 320), 321: (324, 328),
            512: (512, 512), 576: (576, 576)}
    for d, (f32, bf16) in want.items():
        assert instance_head_dim(d, torch.float32) == f32
        assert instance_head_dim(d, torch.bfloat16) == bf16
    assert pad_head_dim(*(torch.zeros((1, 1, 2, 32)),) * 3, 32)[0].shape[-1] == 32
    for d in (0, -1):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            instance_head_dim(d, torch.float32)


def test_head_dim_above_128_raises_off_the_cpu():
    """d = 257 runs on the card padded to its wide instance; a tensor on a
    device without a kernel raises ValueError before any launch (the plain
    version on the CPU takes any d)."""
    m = torch.zeros((1, 4, 8, 257), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(m, m, m)
    c = torch.zeros((1, 4, 8, 257))
    assert flash_attention(c, c, c).shape == c.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_head_dim_matches_reference_kernel(causal, dtype):
    """d = 320, above 256: the port's path (the card's wide instance takes
    320 as it is in both dtypes, so no padding) through the plain version
    against the reference's kernel in interpret mode, GQA at ragged cross
    lengths."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(11, 1, 4, 2, 24, 40, 320), dtype)
    assert instance_head_dim(320, dtype) == 320
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    kernel = jax_flash(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=TOL[dtype], rtol=TOL[dtype])
