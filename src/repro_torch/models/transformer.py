"""The decoder family: dense and MoE decoder stacks with GQA or MLA
attention, as ``nn.Module``s.

    init_params(cfg, seed=, device=)         -> (params, specs)
    forward_train(net, batch)                -> (loss, {"loss", "aux"})
    prefill(net, batch)                      -> (last_logits, caches)
    decode_step(net, token, caches, pos)     -> (logits, caches)

Training keeps the reference's parameter tree: nested dicts whose layer
leaves are stacked on a leading ``(L, ...)`` axis (``init_params``, built
by ``stacked_init``), beside a specs tree of logical axis names equal to
the reference's.  ``module_state`` names that tree's tensors as
``DecoderLM``'s parameters, layer ``i`` of a stacked leaf being its
``unbind(0)[i]`` (whose backward is one ``stack``), so
``torch.func.functional_call`` runs a ``DecoderLM`` on the meta device,
which allocates nothing, over the tree (``zoo.Model.train_loss``).

A ``DecoderLM`` holds the embedding, an ``nn.ModuleList`` of
``DecoderLayer``s, the final norm and the LM head; a Python loop over the
layers replaces the reference's ``lax.scan``.  KV caches keep the
reference's layout, stacked on a leading layer axis:
``{"k": (L, B, Hkv, S, hd), "v": ...}`` for GQA, ``{"c": (L, B, S,
kv_lora), "kr": (L, B, S, rope)}`` for MLA.  Prefill allocates them once at a
``capacity`` (the prompt length by default; ``greedy_generate`` asks for
prompt + new tokens) with zeros past the prompt, and each decode step
writes its position in place.

Vocab is padded to a multiple of 256, as in the reference; padded rows are
ordinary parameters that real tokens never select.

Prefill runs self-attention through the ``flash_attention`` kernel on the
card (``use_flash``, the reference's ``gqa_apply`` argument that its
``attention.py`` says the kernel replaces the dense path with); on the CPU
it takes the reference's own dense or chunked paths.  The reference's
``distributed.context.constrain`` is the identity without a mesh and is
dropped.

MoE configs (``cfg.moe``) put ``models/moe.py``'s routed experts in every
layer's FFN, as the reference does (``moe_every`` is ignored there too):
prefill and decode route dropless, training at capacity, and
``forward_train`` adds the layers' summed load-balance loss.  MLA
(``cfg.mla``) takes ``attention.mla_apply``, which never runs the flash
kernel.

Dense GQA configs (qwen2.5-3b, qwen2-72b, granite-3-8b, internlm2-20b) and
the MoE family (qwen3-moe-30b-a3b, deepseek-v2-lite-16b with MLA) run; the
rwkv, hybrid, encoder-decoder and frontend families raise
``NotImplementedError``: they are later slices of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import GQAttention, MLAttention, gqa_apply, mla_apply
from repro_torch.models.layers import (
    Dense,
    Embedding,
    RMSNorm,
    SwiGLU,
    acc_dtype,
    rope_angles,
    truncnorm_,
)
from repro_torch.models.moe import MoE, moe_apply

VOCAB_PAD = 256

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; pass "
            "device='cpu' (--device cpu) to run the plain-PyTorch path"
        )
    return dev


def padded_vocab(cfg: ArchConfig) -> int:
    return ((cfg.vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run
    yet, naming the slice that brings it (ROADMAP queue 1, the LM
    pillar)."""
    for unported, slice_name in (
        (cfg.ssm, "the rwkv slice (models/ssm.py)"),
        (cfg.hybrid, "the hybrid (zamba2) slice"),
        (cfg.encoder_decoder, "the encoder-decoder slice"),
        (cfg.frontend, "the frontend slice"),
    ):
        if unported:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): not ported yet; it comes with "
                f"{slice_name} of the LM pillar (ROADMAP queue 1)"
            )


class DecoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + ffn(ln2(x)); attn is GQA
    or MLA, ffn a SwiGLU or the MoE."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        if cfg.mla:
            self.attn = MLAttention(cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora_rank,
                                    qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                                    v_dim=cfg.v_head_dim, **kw)
        else:
            self.attn = GQAttention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, bias=cfg.qkv_bias, **kw)
        if cfg.moe:
            self.mlp = MoE(cfg.d_model, n_experts=cfg.n_experts, d_ff_expert=cfg.d_ff_expert,
                           n_shared=cfg.n_shared_experts, d_ff_shared=cfg.d_ff_expert, **kw)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def reset(self, generator: torch.Generator | None) -> None:
        self.ln1.reset()
        self.ln2.reset()
        self.attn.reset(generator)
        self.mlp.reset(generator)

    def forward(self, x, *, cos, sin, mode, cache=None, pos=None, use_flash=False,
                dropless=True):
        """(x, cache, aux): ``aux`` is the MoE's load-balance loss, None for
        a SwiGLU FFN."""
        cfg = self.cfg
        if cfg.mla:
            h, new_cache = mla_apply(
                self.attn, self.ln1(x), n_heads=cfg.n_heads, kv_lora=cfg.kv_lora_rank,
                qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                v_dim=cfg.v_head_dim, cos=cos, sin=sin, mode=mode, cache=cache, pos=pos,
            )
        else:
            h, new_cache = gqa_apply(
                self.attn, self.ln1(x), n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, cos=cos, sin=sin, mode=mode,
                cache=cache, pos=pos, use_flash=use_flash,
            )
        x = x + h
        h2 = self.ln2(x)
        if cfg.moe:
            ff, aux = moe_apply(self.mlp, h2, n_experts=cfg.n_experts, top_k=cfg.top_k,
                                dropless=dropless)
        else:
            ff, aux = self.mlp(h2), None
        return x + ff, new_cache, aux


class DecoderLM(nn.Module):
    """Embedding, decoder layers, final norm and LM head of one config, its
    parameters in ``cfg.dtype`` (an MoE router's in float32) on ``device``,
    the card by default (left uninitialised until ``init_params``;
    ``device="meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        check_supported(cfg)
        kw = dict(dtype=TORCH_DTYPES[cfg.dtype], device=resolve_device(device))
        self.cfg = cfg
        vocab = padded_vocab(cfg)
        self.embed = Embedding(vocab, cfg.d_model, **kw)
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.lm_head = Dense(cfg.d_model, vocab, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_params(self, seed: int = 0) -> None:
        """Draw every parameter in place on its device from one generator
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed.reset(gen)
        self.final_norm.reset()
        self.lm_head.reset(gen)
        for layer in self.layers:
            layer.reset(gen)

    def forward(self, batch: dict, *, remat_policy=None, aux_weight: float = 0.01):
        """The training loss, ``forward_train``: what ``functional_call``
        runs over a parameter tree."""
        return forward_train(self, batch, remat_policy=remat_policy, aux_weight=aux_weight)


# ============================================================ parameter trees


def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(t, (str, type(None))) for t in x)


def map_specs(fn, specs):
    """``fn`` applied to every logical-axis tuple of a specs tree."""
    if _is_spec_leaf(specs):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def stacked_init(init_fn, n: int):
    """Draw n layers in one call and prepend the 'layers' logical axis.

    ``init_fn(lead)`` returns (params, specs) with every leaf shaped
    ``lead + shape``; the reference vmaps an init over n layer keys, and one
    draw of the stacked shape has the same distribution."""
    params, specs = init_fn((n,))
    return params, map_specs(lambda ax: ("layers",) + ax, specs)


class _Init:
    """Leaf makers on one device and dtype, drawing from one generator (none
    on the meta device, where nothing is drawn)."""

    def __init__(self, dtype, device, seed):
        self.kw = dict(dtype=dtype, device=device)
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    def normal(self, shape, scale, dtype=None):
        """Truncated normal drawn in float32 (or wider) and cast, as the
        reference draws in float32 and casts to the config's dtype (or to
        ``dtype``)."""
        dtype = self.kw["dtype"] if dtype is None else dtype
        t = torch.empty(shape, dtype=acc_dtype(dtype), device=self.kw["device"])
        if self.gen is not None:
            truncnorm_(t, scale, self.gen)
        return t.to(dtype)

    def dense(self, lead, in_dim, out_dim, in_ax, out_ax, *, bias=False):
        p = {"w": self.normal(lead + (in_dim, out_dim), in_dim**-0.5)}
        s = {"w": (in_ax, out_ax)}
        if bias:
            p["b"] = torch.zeros(lead + (out_dim,), **self.kw)
            s["b"] = (out_ax,)
        return p, s

    def rmsnorm(self, lead, dim):
        return {"scale": torch.ones(lead + (dim,), **self.kw)}, {"scale": ("embed",)}


def _unzip(pairs: dict):
    """{name: (params, specs)} -> ({name: params}, {name: specs})."""
    return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}


def _swiglu_init(ini: _Init, lead: tuple, d_model: int, d_ff: int):
    return _unzip({
        "wi": ini.dense(lead, d_model, d_ff, "embed", "mlp"),
        "wg": ini.dense(lead, d_model, d_ff, "embed", "mlp"),
        "wo": ini.dense(lead, d_ff, d_model, "mlp", "embed"),
    })


def _attn_init(ini: _Init, cfg: ArchConfig, lead: tuple):
    D, H = cfg.d_model, cfg.n_heads

    def dense(*args, **kwargs):
        return ini.dense(lead, *args, **kwargs)

    if cfg.mla:
        lora, nope, rope = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
        return _unzip({
            "wq": dense(D, H * (nope + rope), "embed", "heads"),
            "wdkv": dense(D, lora, "embed", "lora"),
            "wkrope": dense(D, rope, "embed", "lora"),
            "wuk": dense(lora, H * nope, "lora", "heads"),
            "wuv": dense(lora, H * cfg.v_head_dim, "lora", "heads"),
            "wo": dense(H * cfg.v_head_dim, D, "heads", "embed"),
        })
    hd, bias = cfg.resolved_head_dim, cfg.qkv_bias
    return _unzip({
        "wq": dense(D, H * hd, "embed", "heads", bias=bias),
        "wk": dense(D, cfg.n_kv_heads * hd, "embed", "kv", bias=bias),
        "wv": dense(D, cfg.n_kv_heads * hd, "embed", "kv", bias=bias),
        "wo": dense(H * hd, D, "heads", "embed"),
    })


def _moe_init(ini: _Init, cfg: ArchConfig, lead: tuple):
    """The reference's ``moe_init`` tree: a float32 router, bare stacked
    expert weights, the shared SwiGLU when the config has one."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": {"w": ini.normal(lead + (D, E), D**-0.5, dtype=torch.float32)},
        "wi": ini.normal(lead + (E, D, F), D**-0.5),
        "wg": ini.normal(lead + (E, D, F), D**-0.5),
        "wo": ini.normal(lead + (E, F, D), F**-0.5),
    }
    s = {
        "router": {"w": ("embed", "expert")},
        "wi": ("expert", "embed", "mlp"),
        "wg": ("expert", "embed", "mlp"),
        "wo": ("expert", "mlp", "embed"),
    }
    if cfg.n_shared_experts:
        p["shared"], s["shared"] = _swiglu_init(ini, lead, D, cfg.n_shared_experts * F)
    return p, s


def _decoder_layer_init(ini: _Init, cfg: ArchConfig, lead: tuple):
    D = cfg.d_model
    return _unzip({
        "ln1": ini.rmsnorm(lead, D),
        "ln2": ini.rmsnorm(lead, D),
        "attn": _attn_init(ini, cfg, lead),
        "mlp": _moe_init(ini, cfg, lead) if cfg.moe else _swiglu_init(ini, lead, D, cfg.d_ff),
    })


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda"):
    """(params, specs) in the reference's tree, in ``cfg.dtype`` on
    ``device``: the embedding table truncated normal at scale 1.0, each
    projection at d_in**-0.5, norm scales ones, biases zeros (the
    reference's ``layers.py`` scales), drawn from a generator seeded with
    ``seed``; the layers stacked on a leading (L, ...) axis.  On the meta
    device nothing is drawn or allocated.  The two packages' generators
    differ, so parity tests convert the reference's tree
    (``convert.tree_from_reference``)."""
    check_supported(cfg)
    ini = _Init(TORCH_DTYPES[cfg.dtype], resolve_device(device), seed)
    vocab, D = padded_vocab(cfg), cfg.d_model
    return _unzip({
        "embed": ({"table": ini.normal((vocab, D), 1.0)}, {"table": ("vocab", "embed")}),
        "final_norm": ini.rmsnorm((), D),
        "lm_head": ini.dense((), D, vocab, "embed", "vocab"),
        "layers": stacked_init(lambda lead: _decoder_layer_init(ini, cfg, lead), cfg.n_layers),
    })


def _dotted(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            yield from _dotted(value, path)
        else:
            yield path, value


def module_state(params: dict) -> dict[str, torch.Tensor]:
    """The stacked tree under ``DecoderLM``'s parameter names: layer ``i``
    of each stacked leaf (``unbind(0)``, no copy) as ``layers.<i>.*``,
    every other leaf under its dotted path."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _dotted(params):
        if path[0] == "layers":
            for i, t in enumerate(leaf.unbind(0)):
                out[".".join(("layers", str(i)) + path[1:])] = t
        else:
            out[".".join(path)] = leaf
    return out


def _rope_cache(cfg: ArchConfig, positions: torch.Tensor):
    if cfg.mla:
        return rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def cache_seq_axis(cfg: ArchConfig) -> int:
    """The seq axis of the stacked caches: 2 for MLA's latent c (L, B, S,
    kv_lora) and rope key kr (L, B, S, rope), 3 for GQA's k/v (L, B, Hkv,
    S, hd)."""
    return 2 if cfg.mla else 3


def _cache_shapes(cfg: ArchConfig, B: int, cap: int) -> dict:
    """{name: stacked shape} of the prefill caches at ``cap`` positions."""
    L = cfg.n_layers
    if cfg.mla:
        return {"c": (L, B, cap, cfg.kv_lora_rank), "kr": (L, B, cap, cfg.qk_rope_dim)}
    shape = (L, B, cfg.n_kv_heads, cap, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def _embed_sequence(net: DecoderLM, batch: dict) -> torch.Tensor:
    return net.embed(batch["tokens"])


def _run_decoder_stack(net: DecoderLM, x, *, mode, caches=None, pos=None,
                       use_flash=False, capacity=None):
    cfg = net.cfg
    B, S, _ = x.shape
    if mode == "decode":
        # filled on the device: a tensor built from a host list would be a
        # pageable copy, which waits for the device at every decode step
        positions = torch.full((1,), int(pos), device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    cos, sin = _rope_cache(cfg, positions)

    if mode == "decode":
        for i, layer in enumerate(net.layers):
            x, _, _ = layer(x, cos=cos, sin=sin, mode="decode",
                            cache={name: c[i] for name, c in caches.items()}, pos=pos)
        return x, caches

    cap = S if capacity is None else max(int(capacity), S)
    caches = {name: torch.zeros(shape, dtype=x.dtype, device=x.device)
              for name, shape in _cache_shapes(cfg, B, cap).items()}
    seq_axis = cache_seq_axis(cfg) - 1  # of one layer's cache
    for i, layer in enumerate(net.layers):
        x, cache, _ = layer(x, cos=cos, sin=sin, mode=mode, use_flash=use_flash)
        for name, c in caches.items():
            c[i].narrow(seq_axis, 0, S).copy_(cache[name])
    return x, caches


def _remat_layer(layer, names, x, cos, sin, *tensors):
    """One training layer over explicit tensors, returning (y, aux or None):
    checkpoint's recomputation runs in the backward pass, after any outer
    ``functional_call`` has put the module's own parameters back."""
    params = dict(zip(names, tensors))
    y, _, aux = torch.func.functional_call(
        layer, params, (x,), dict(cos=cos, sin=sin, mode="causal", dropless=False),
        strict=True)
    return y, aux


def _run_train_stack(net: DecoderLM, x, *, remat_policy=None):
    """The causal stack for training: no KV caches, the MoE at capacity
    (``dropless=False``).  Returns (x, the sum over layers of the aux
    loss, a float32 zero without MoE layers).  ``remat_policy`` (a selective-checkpoint policy of
    ``train.step.REMAT_POLICIES``, or None) checkpoints each layer, the
    reference's ``jax.checkpoint`` on its scan body."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    S = x.shape[1]
    cos, sin = _rope_cache(net.cfg, torch.arange(S, device=x.device))
    auxs = []
    for layer in net.layers:
        if remat_policy is None:
            x, _, aux = layer(x, cos=cos, sin=sin, mode="causal", dropless=False)
        else:
            names, tensors = zip(*layer.named_parameters())
            x, aux = checkpoint(
                _remat_layer, layer, names, x, cos, sin, *tensors, use_reentrant=False,
                context_fn=lambda: create_selective_checkpoint_contexts(remat_policy),
            )
        if aux is not None:
            auxs.append(aux)
    if not auxs:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.sum(torch.stack(auxs))


def token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, logsumexp(logits) - logit[target], in
    float32 (float64 for float64 logits), over the padded vocab."""
    logits = logits.to(acc_dtype(logits.dtype))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - ll)


def forward_train(net: DecoderLM, batch: dict, *, remat_policy=None, aux_weight: float = 0.01):
    """(loss + aux_weight * aux, {"loss", "aux"}) of a batch of tokens and
    targets; ``aux`` is the sum over layers of the MoE balance loss (0 for
    the dense family)."""
    x, aux = _run_train_stack(net, _embed_sequence(net, batch), remat_policy=remat_policy)
    x = net.final_norm(x)
    loss = token_loss(net.lm_head(x), batch["targets"])
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def backbone_apply(net: DecoderLM, batch: dict, *, mode, caches=None, pos=None,
                   use_flash=False, capacity=None):
    """The decoder stack over the batch's tokens; returns (hidden,
    caches)."""
    x = _embed_sequence(net, batch)
    return _run_decoder_stack(net, x, mode=mode, caches=caches, pos=pos,
                              use_flash=use_flash, capacity=capacity)


def prefill(net: DecoderLM, batch: dict, *, capacity=None, use_flash=None):
    """Logits of the last position, (B, padded vocab), and the KV caches
    (capacity positions, the prompt's written).  ``use_flash=None`` is the
    device's choice: the kernel on the card, the reference's paths on the
    CPU; ``False`` forces the reference's dense path (a check's oracle)."""
    if use_flash is None:
        use_flash = net.device.type == "cuda"
    x, caches = backbone_apply(net, batch, mode="causal", use_flash=use_flash,
                               capacity=capacity)
    x = net.final_norm(x[:, -1:])
    return net.lm_head(x)[:, 0], caches


def decode_step(net: DecoderLM, token: torch.Tensor, caches: dict, pos):
    """token: (B, 1) int; pos: the write index.  The caches are written in
    place and returned."""
    x, caches = backbone_apply(net, {"tokens": token}, mode="decode", caches=caches, pos=pos)
    x = net.final_norm(x)
    return net.lm_head(x)[:, 0], caches
