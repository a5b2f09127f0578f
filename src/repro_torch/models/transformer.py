"""Model assembly for every family of the JAX package.

The counterpart of the JAX package's ``models/transformer.py``:
  dense / moe / vlm : decoder-only transformer.
  ssm (rwkv6)       : a stack of RWKV6 blocks.
  hybrid (zamba2)   : groups of ``attn_every`` Mamba2 layers, each group
                      followed by one SHARED (weight-tied) attention block
                      on the group's input times a per-group gain.
  audio (whisper)   : encoder-decoder; the mel/conv front end is stubbed
                      (``batch["frames"]`` holds the encoder's input
                      embeddings).  As in the JAX package the encoder's self
                      attention is causal; only the cross attention is not.
Parameters are a nested dict of tensors with the JAX package's keys, each
layer leaf stacked on a leading (L, ...) axis; the layers run as a Python
loop over views of those leaves.

Entry points, used by serving and training:
  init_params(cfg, seed, device)             -> params
  params_from_numpy(tree, cfg, device)       -> params (from the JAX package's)
  forward(params, cfg, batch, remat=)        -> dict(logits (B, S, V) f32, ...)
  init_cache(cfg, batch, max_seq, device=)   -> cache
  prefill(params, cfg, batch, max_seq)       -> (logits_last, cache)
  decode_step(params, cfg, cache, tokens)    -> (logits, cache)

``decode_step`` writes the new kv entries (for ssm the WKV state and the
token shifts, for hybrid also the Mamba2 conv and ssm states) into the cache
tensors in place (the counterpart of the JAX package donating its cache) and
never reads a device value on the host, so a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve_device
from repro_torch.distributed import ctx
from repro_torch.models import layers, moe, rope, ssm
from repro_torch.models.attention import attention, decode_attention
from repro_torch.serving.formats import QTensor

SUPPORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig):
    if cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(repro_torch runs {SUPPORTED_FAMILIES})")


# =============================================================================
# init
# =============================================================================


def _attn_specs(cfg: ModelConfig):
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = D ** -0.5
    p = {
        "wq": ((D, H * hd), "normal", s),
        "wk": ((D, K * hd), "normal", s),
        "wv": ((D, K * hd), "normal", s),
        "wo": ((H * hd, D), "normal", (H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = ((H * hd,), "zeros", None)
        p["bk"] = ((K * hd,), "zeros", None)
        p["bv"] = ((K * hd,), "zeros", None)
    if cfg.qk_norm:
        p["q_norm"] = ((hd,), "ones", None)
        p["k_norm"] = ((hd,), "ones", None)
    return p


class Leaf(NamedTuple):
    """How one parameter is made."""

    shape: tuple
    init: str                             # normal | ones | zeros | full
    scale: Optional[float] = None         # std of normal, the value of full
    dtype: Optional[torch.dtype] = None   # None: the model's dtype
    layers: int = 0                       # > 0: stacked on a leading (L, ...) axis


def _leaves(specs, n: int = 0):
    """Module specs ((shape, init, scale[, dtype]) tuples) as Leafs, stacked
    on a leading axis of ``n`` layers when n > 0."""
    if isinstance(specs, dict):
        return {k: _leaves(v, n) for k, v in specs.items()}
    shape, init, scale, *dtype = specs
    return Leaf((n, *shape) if n else tuple(shape), init, scale,
                dtype[0] if dtype else None, n)


def _decoder_layer_specs(cfg: ModelConfig):
    D = cfg.d_model
    layer = {
        "ln1": ((D,), "ones", None),
        "ln2": ((D,), "ones", None),
        "attn": _attn_specs(cfg),
    }
    if cfg.is_moe:
        layer["moe_block"] = moe.moe_block_specs(cfg)
    else:
        layer["mlp"] = layers.mlp_specs(D, cfg.d_ff, cfg.mlp)
    return layer


def _xattn_layer_specs(cfg: ModelConfig):
    """Whisper decoder layer: self attention, cross attention, gelu mlp."""
    D = cfg.d_model
    return {
        "ln1": ((D,), "ones", None),
        "lnx": ((D,), "ones", None),
        "ln2": ((D,), "ones", None),
        "attn": _attn_specs(cfg),
        "xattn": _attn_specs(cfg),
        "mlp": layers.mlp_specs(D, cfg.d_ff, cfg.mlp),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """{key: Leaf} with the JAX package's tree, shapes, dtypes and scales."""
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ((V, D), "normal", 0.02),
        "final_norm": ((D,), "ones", None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((D, V), "normal", D ** -0.5)
    specs = _leaves(specs)
    L = cfg.num_layers
    if cfg.family == "ssm":
        specs["layers"] = _leaves(ssm.rwkv6_layer_specs(D, cfg.d_ff, cfg.ssm_head_dim), L)
    elif cfg.family == "hybrid":
        specs["mamba_layers"] = _leaves(ssm.mamba2_layer_specs(
            D, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim), L)
        specs["shared"] = _leaves(_decoder_layer_specs(cfg))
        specs["group_gain"] = _leaves(((L // cfg.attn_every, D), "ones", None))
    elif cfg.family == "audio":
        specs["enc_layers"] = _leaves(_decoder_layer_specs(cfg), cfg.encoder_layers)
        specs["enc_final_norm"] = _leaves(((D,), "ones", None))
        specs["dec_layers"] = _leaves(_xattn_layer_specs(cfg), L)
    else:
        specs["layers"] = _leaves(_decoder_layer_specs(cfg), L)
    return specs


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` (a torch.Generator on ``device``).

    Same tree, shapes and init scales as the JAX package; the numbers differ,
    since the two generators differ.  Tests that compare the two packages
    convert the JAX package's parameters with ``params_from_numpy``.

    A stacked leaf is drawn one layer slab at a time into a tensor of its
    own dtype, so the float32 temporary is one slab (one layer's (E, D, F)
    experts at most), not the whole (L, ...) leaf.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(shape, scale, dtype):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dtype)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        dtype = spec.dtype or cfg.torch_dtype
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "full":
            return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
        if not spec.layers:
            return draw(spec.shape, spec.scale, dtype)
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        for i in range(spec.layers):
            out[i] = draw(spec.shape[1:], spec.scale, dtype)
        return out

    return make(param_specs(cfg))


def _leaf_to_torch(leaf, device):
    arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":   # numpy has no bf16; torch does
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's, given as numpy arrays.

    ``tree`` is a nested dict; a leaf is an array, or any object with ``.wq``
    and ``.scales`` (a QTensor of either package), which becomes a port
    ``QTensor``.  Keys and shapes are checked against ``cfg``.
    """
    device = resolve_device(device)

    def convert(node, spec, key):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                raise ValueError(f"{key or 'params'}: keys {sorted(node)} != "
                                 f"{sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{key}/{k}" if key else k)
                    for k in spec}
        shape = spec.shape
        if hasattr(node, "wq"):
            out = QTensor(_leaf_to_torch(node.wq, device),
                          _leaf_to_torch(node.scales, device))
        else:
            out = _leaf_to_torch(node, device)
        if tuple(out.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(out.shape)} != {shape}")
        return out

    return convert(tree, param_specs(cfg), "")


def _unbind(tree):
    """Each stacked (L, ...) leaf as its L views along the first axis."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return [QTensor(wq, sc) for wq, sc in zip(tree.wq.unbind(0), tree.scales.unbind(0))]
    return tree.unbind(0)


def _pick(views, i: int):
    if isinstance(views, dict):
        return {k: _pick(v, i) for k, v in views.items()}
    return views[i]


def _layers(stacked, n: int):
    """The parameters of each of the ``n`` layers of a stacked (L, ...) tree:
    views from one ``unbind`` of each leaf.  Under autograd a leaf's gradient
    is then one stack of its layers' gradients; indexing each layer instead
    would scatter every layer's gradient into a zeroed full-size (L, ...)
    tensor and add the L of them up."""
    views = _unbind(stacked)
    return [_pick(views, i) for i in range(n)]


# =============================================================================
# attention sublayer (shared by full-seq and decode paths)
# =============================================================================


def _q_proj(p, cfg: ModelConfig, x):
    """The query projection of ``_qkv``, before rope (alone: cross attention)."""
    B, S = x.shape[0], x.shape[1]
    q = layers.dense(x, p["wq"], p.get("bq")).reshape(B, S, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _qkv(p, cfg: ModelConfig, x, angles):
    B, S = x.shape[0], x.shape[1]
    K, hd = cfg.num_kv_heads, cfg.head_dim
    q = _q_proj(p, cfg, x)
    k = layers.dense(x, p["wk"], p.get("bk")).reshape(B, S, K, hd)
    v = layers.dense(x, p["wv"], p.get("bv")).reshape(B, S, K, hd)
    if cfg.qk_norm:
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if angles is not None:
        q = rope.apply_rotary(q, angles)
        k = rope.apply_rotary(k, angles)
    return q, k, v


def _self_attention_full(p, cfg, x, angles, *, causal=True, window=None):
    """Full-sequence self attention. Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles)
    o = attention(q, k, v, causal=causal, window=window)
    return layers.dense(o.reshape(B, S, -1), p["wo"]), (k, v)


def _write_slots(cache, lengths, uniform: bool):
    """Where each slot writes its new kv entry, once a step for every layer:
    (position (B,), keep (B, 1, 1), the k and v entries (L, B, K, hd) now
    at those positions).

    A slot at or past the cache's end (a free slot of a continuous batch
    keeps stepping) drops its write, as the JAX package's scatter does: it
    writes back the entry already at the clamped position.  A layer writes
    only its own entries, so the step's old entries are read once, before
    the first layer."""
    B, S = lengths.shape[0], cache["k"].shape[2]
    if uniform:
        # lockstep decode pool: every slot writes at slot 0's position
        lengths = lengths[:1].expand(B)
    pos = lengths.clamp(max=S - 1)
    bidx = torch.arange(B, device=lengths.device)
    return pos, (lengths < S)[:, None, None], cache["k"][:, bidx, pos], cache["v"][:, bidx, pos]


def _self_attention_decode(p, cfg, x, angles, kc, vc, lengths, write, *, window=None):
    """One-token self attention against a cache.

    x: (B, 1, D); kc/vc: (B, Smax, K, hd); lengths: (B,) BEFORE this token;
    write: (position, keep, old k, old v) from ``_write_slots``, the old
    entries this layer's.  Writes the new kv into kc/vc in place; returns
    out (B,1,D).

    When a sliding window is active and much smaller than the cache, only the
    last ``window`` cache entries are gathered and attended -- decode compute
    is O(window), not O(cache) (the long-context path).
    """
    B = x.shape[0]
    S = kc.shape[1]
    q, k, v = _qkv(p, cfg, x, angles)  # k,v: (B,1,K,hd)
    bidx = torch.arange(B, device=x.device)
    # the JAX package writes functionally into a donated cache; here the
    # write is in place, with index_put_, and reads lengths on the device
    pos, keep, k_old, v_old = write
    kc.index_put_((bidx, pos), torch.where(keep, k[:, 0].to(kc.dtype), k_old))
    vc.index_put_((bidx, pos), torch.where(keep, v[:, 0].to(vc.dtype), v_old))
    if window is not None and S > 2 * window:
        new_len = lengths + 1
        start = torch.clamp(new_len - window, min=0)                     # (B,)
        idx = start[:, None] + torch.arange(window, dtype=torch.int32,
                                            device=x.device)[None, :]
        idx = torch.clamp(idx, max=S - 1)
        kw = kc[bidx[:, None], idx]                                      # (B,W,K,hd)
        vw = vc[bidx[:, None], idx]
        eff_len = torch.clamp(new_len, max=window)
        o = decode_attention(q[:, 0], kw, vw, eff_len, window=None)
    else:
        o = decode_attention(q[:, 0], kc, vc, lengths + 1, window=window)
    return layers.dense(o.reshape(B, 1, -1), p["wo"])


def _cross_attention(p, cfg, x, enc_k, enc_v):
    """Non-causal attention of the decoder's queries over the encoder's k/v."""
    B, S, _ = x.shape
    o = attention(_q_proj(p, cfg, x), enc_k, enc_v, causal=False)
    return layers.dense(o.reshape(B, S, -1), p["wo"])


def _enc_kv(p, cfg, enc_out):
    B, T, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    k = layers.dense(enc_out, p["wk"], p.get("bk")).reshape(B, T, K, hd)
    v = layers.dense(enc_out, p["wv"], p.get("bv")).reshape(B, T, K, hd)
    return k, v


def _ffn(p, cfg: ModelConfig, x):
    """Returns (out, aux_loss or None)."""
    if cfg.is_moe:
        return moe.apply_moe_block(p["moe_block"], x, cfg)
    return layers.apply_mlp(p["mlp"], x, cfg.mlp), None


def _decoder_layer(p, cfg, x, angles, *, window, remat: bool = False):
    """Standard pre-norm decoder layer. Returns (x, (k, v), aux or None).

    ``remat`` recomputes the layer's activations in the backward instead of
    keeping them (the JAX package's checkpoint of the layer body).
    """

    def body(p, x, angles):
        x = ctx.constrain(x, ("dp", None, None))
        h, kv = _self_attention_full(
            p["attn"], cfg, layers.rms_norm(x, p["ln1"], cfg.norm_eps),
            angles, window=window,
        )
        x = x + h
        h, aux = _ffn(p, cfg, layers.rms_norm(x, p["ln2"], cfg.norm_eps))
        return x + h, kv, aux

    if remat:
        return checkpoint(body, p, x, angles, use_reentrant=False)
    return body(p, x, angles)


# =============================================================================
# full-sequence forward (prefill scoring)
# =============================================================================


def _rope_angles_for(cfg: ModelConfig, batch, B, S, device):
    if cfg.rope_theta == 0.0:
        return None
    pos = batch.get("positions")
    if cfg.mrope:
        if pos is None:
            p = rope.positions_default(B, S, device=device)
            pos = torch.stack([p, p, p])  # text-only: t==h==w
        return rope.mrope_angles(pos, cfg.head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
    if pos is None:
        pos = rope.positions_default(B, S, device=device)
    return rope.rope_angles(pos, cfg.head_dim, cfg.rope_theta)


def _sinusoid(positions, D: int):
    """Sinusoidal position embeddings (whisper) at ``positions`` (N,): (N, D) f32."""
    pos = positions.to(torch.float32)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = pos / (10000.0 ** (2 * i / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_in(params, cfg, batch):
    if batch.get("embeds") is not None:
        x = batch["embeds"].to(cfg.torch_dtype)
    else:
        x = layers.embed(batch["tokens"], params["embed"])
    # pin batch sharding on the residual stream entry (the embedding table's
    # own sharding must not leak onto activations)
    return ctx.constrain(x, ("dp", None, None))


def _lm_logits(params, cfg, x, logits_for: str = "all"):
    if logits_for == "last":
        x = x[:, -1:]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return layers.unembed(x, table)


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False,
            collect_kv: bool = False, logits_for: str = "all"):
    """Full-sequence scoring. Returns dict(logits, aux_loss [, kv | state | xkv]).

    ``remat`` checkpoints each decoder layer (dense, moe, vlm) and the hybrid
    family's shared block, as the JAX package's ``forward(..., remat)``.

    logits_for="last" computes the LM head on the final position only (the
    prefill path: avoids materializing the (B, S, V) logits tensor).  With
    ``collect_kv`` an attention family returns ``kv`` (k, v) each
    (L, B, S, K, hd) (hybrid: one per group, (G, B, S, K, hd)); ssm returns
    ``state`` {"wkv", "tm_shift", "cm_shift"} and hybrid ``state`` {"conv",
    "ssm"}, stacked over layers; audio also returns ``xkv``, the cross
    attention's (k, v) each (L, B, encoder_seq, K, hd).
    """
    _check_family(cfg)
    if cfg.family == "audio":
        return _forward_whisper(params, cfg, batch, collect_kv=collect_kv,
                                logits_for=logits_for)
    x = _embed_in(params, cfg, batch)
    B, S, _ = x.shape
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    out = {}
    if cfg.family == "ssm":
        collected = []
        for lp in _layers(params["layers"], cfg.num_layers):
            x = ctx.constrain(x, ("dp", None, None))
            x, state = ssm.rwkv6_block(lp, x, cfg.ssm_head_dim)
            if collect_kv:
                collected.append(state)
        if collect_kv:
            out["state"] = {key: torch.stack([st[key] for st in collected])
                            for key in ("wkv", "tm_shift", "cm_shift")}
    elif cfg.family == "hybrid":
        x, state, kv = _forward_hybrid(params, cfg, batch, x, remat=remat)
        if collect_kv:
            out["state"], out["kv"] = state, kv
    else:
        angles = _rope_angles_for(cfg, batch, B, S, x.device)
        collected = []
        for lp in _layers(params["layers"], cfg.num_layers):
            x, kv, aux = _decoder_layer(lp, cfg, x, angles, window=cfg.attn_window,
                                        remat=remat)
            if aux is not None:
                aux_total = aux_total + aux
            if collect_kv:
                collected.append(kv)
        if collect_kv:
            out["kv"] = _stack_kv(collected)
    return dict(out, logits=_lm_logits(params, cfg, x, logits_for), aux_loss=aux_total)


def _stack_kv(kvs):
    """[(k, v)] per layer -> (k, v) each (L, B, S, K, hd)."""
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _forward_hybrid(params, cfg, batch, x, remat: bool = False):
    """Returns (x, {"conv", "ssm"} each (L, ...), kv (G, B, S, K, hd) pair)."""
    B, S, _ = x.shape
    angles = _rope_angles_for(cfg, batch, B, S, x.device)
    mamba = _layers(params["mamba_layers"], cfg.num_layers)
    ae = cfg.attn_every
    states, kvs = [], []
    for g in range(cfg.num_layers // ae):
        for lp in mamba[g * ae:(g + 1) * ae]:
            x = ctx.constrain(x, ("dp", None, None))
            x, st = ssm.mamba2_block(lp, x, head_dim=cfg.ssm_head_dim,
                                     ssm_state=cfg.ssm_state)
            states.append(st)
        # the shared (weight-tied) attention block, on a per-group input gain
        x, kv, _ = _decoder_layer(params["shared"], cfg, x * params["group_gain"][g],
                                  angles, window=cfg.attn_window, remat=remat)
        kvs.append(kv)
    state = {key: torch.stack([st[key] for st in states]) for key in ("conv", "ssm")}
    return x, state, _stack_kv(kvs)


def _forward_whisper(params, cfg, batch, *, collect_kv=False, logits_for: str = "all"):
    """batch: frames (B, encoder_seq, D) from the stub front end + decoder tokens."""
    dt = cfg.torch_dtype
    frames = batch["frames"]
    T = frames.shape[1]
    enc = frames.to(dt) + _sinusoid(torch.arange(T, device=frames.device),
                                    cfg.d_model).to(dt)
    for lp in _layers(params["enc_layers"], cfg.encoder_layers):
        enc = ctx.constrain(enc, ("dp", None, None))
        enc, _, _ = _decoder_layer(lp, cfg, enc, None, window=None)
    enc = layers.rms_norm(enc, params["enc_final_norm"], cfg.norm_eps)

    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = layers.embed(tokens, params["embed"]) + _sinusoid(
        torch.arange(S, device=tokens.device), cfg.d_model).to(dt)
    kvs, xkvs = [], []
    for lp in _layers(params["dec_layers"], cfg.num_layers):
        x = ctx.constrain(x, ("dp", None, None))
        h, kv = _self_attention_full(
            lp["attn"], cfg, layers.rms_norm(x, lp["ln1"], cfg.norm_eps), None)
        x = x + h
        ek, ev = _enc_kv(lp["xattn"], cfg, enc)
        x = x + _cross_attention(
            lp["xattn"], cfg, layers.rms_norm(x, lp["lnx"], cfg.norm_eps), ek, ev)
        h, _ = _ffn(lp, cfg, layers.rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + h
        kvs.append(kv)
        xkvs.append((ek, ev))
    out = {"logits": _lm_logits(params, cfg, x, logits_for),
           "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
    if collect_kv:
        out["kv"], out["xkv"] = _stack_kv(kvs), _stack_kv(xkvs)
    return out


# =============================================================================
# serving: cache init / prefill / decode_step
# =============================================================================


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """Allocate the decode cache for ``batch_size`` slots of ``max_seq``.

    dense / moe / vlm: k, v (L, B, max_seq, K, hd).  ssm: the WKV state
    (L, B, H, hd, hd) f32 and the token shifts (L, B, D); max_seq is unused.
    hybrid: the Mamba2 conv state (L, B, 3, d_inner + 2 S) and ssm state
    (L, B, nh, hd, S) f32, and the shared block's k, v (G, B, max_seq, K, hd).
    audio: k, v (L, B, max_seq, K, hd) and the cross attention's xk, xv
    (L, B, encoder_seq, K, hd).
    """
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    B, L = batch_size, cfg.num_layers
    lengths = torch.zeros((B,), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        hd = cfg.ssm_head_dim
        H = cfg.d_model // hd
        return {
            "wkv": torch.zeros((L, B, H, hd, hd), dtype=torch.float32, device=device),
            "tm_shift": torch.zeros((L, B, cfg.d_model), dtype=dt, device=device),
            "cm_shift": torch.zeros((L, B, cfg.d_model), dtype=dt, device=device),
            "lengths": lengths,
        }
    K, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == "hybrid":
        G = L // cfg.attn_every
        nh = cfg.d_inner // cfg.ssm_head_dim
        conv = (L, B, ssm.CONV_WIDTH - 1, cfg.d_inner + 2 * cfg.ssm_state)
        return {
            "conv": torch.zeros(conv, dtype=dt, device=device),
            "ssm": torch.zeros((L, B, nh, cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=device),
            "k": torch.zeros((G, B, max_seq, K, hd), dtype=dt, device=device),
            "v": torch.zeros((G, B, max_seq, K, hd), dtype=dt, device=device),
            "lengths": lengths,
        }
    cache = {
        "k": torch.zeros((L, B, max_seq, K, hd), dtype=dt, device=device),
        "v": torch.zeros((L, B, max_seq, K, hd), dtype=dt, device=device),
    }
    if cfg.family == "audio":
        cache["xk"] = torch.zeros((L, B, cfg.encoder_seq, K, hd), dtype=dt, device=device)
        cache["xv"] = torch.zeros((L, B, cfg.encoder_seq, K, hd), dtype=dt, device=device)
    cache["lengths"] = lengths
    return cache


def prefill(params, cfg: ModelConfig, batch, max_seq: int, cache=None):
    """Run the prompt through the model, build the decode cache.

    batch["tokens"]: (B, S) with S <= max_seq (uniform prompt length);
    audio also takes batch["frames"] (B, encoder_seq, D).
    ``cache``, if given, is an ``init_cache`` of B slots that is overwritten
    in place (a CUDA graph's static buffers) instead of allocating one; it
    ends as a fresh cache would.
    Returns (last_logits (B, V), cache) on the batch's device.
    """
    out = forward(params, cfg, batch, collect_kv=True, logits_for="last")
    src = batch["tokens"] if batch.get("tokens") is not None else batch["embeds"]
    B, S = src.shape[0], src.shape[1]
    if cache is None:
        cache = init_cache(cfg, B, max_seq, device=src.device)
    elif cache["lengths"].shape[0] != B or ("k" in cache and cache["k"].shape[2] != max_seq):
        raise ValueError(f"prefill: the cache does not hold {B} slots of {max_seq}")
    for key, value in out.get("state", {}).items():
        cache[key].copy_(value)
    if "kv" in out:
        cache["k"][:, :, S:].zero_()
        cache["v"][:, :, S:].zero_()
        k, v = out["kv"]
        cache["k"][:, :, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :, :S] = v.to(cache["v"].dtype)
    if "xkv" in out:
        cache["xk"].copy_(out["xkv"][0])
        cache["xv"].copy_(out["xkv"][1])
    cache["lengths"].fill_(S)
    return out["logits"][:, -1], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, positions=None,
                uniform_lengths: bool = False):
    """One decode step for every active slot.

    tokens: (B,) int (the previously sampled token). Returns (logits (B, V)
    f32, cache with lengths += 1); the tensors of the returned cache other
    than lengths are those of ``cache``, updated in place: the new kv entry
    of every layer, the recurrent states of every ssm or Mamba2 layer.

    uniform_lengths=True promises every slot is at the same position
    (lockstep decode pools): every slot writes at slot 0's position.
    """
    _check_family(cfg)
    lengths = cache["lengths"]
    B = tokens.shape[0]
    x = layers.embed(tokens, params["embed"])[:, None]  # (B,1,D)
    if cfg.family == "ssm":
        for i, lp in enumerate(_layers(params["layers"], cfg.num_layers)):
            state = {key: cache[key][i] for key in ("wkv", "tm_shift", "cm_shift")}
            # the kernel writes the new WKV state over the old, in place
            x, new = ssm.rwkv6_block(lp, x, cfg.ssm_head_dim, cache=state,
                                     state_out=state["wkv"])
            state["tm_shift"].copy_(new["tm_shift"])
            state["cm_shift"].copy_(new["cm_shift"])
        cache = dict(cache, lengths=lengths + 1)
        return _lm_logits(params, cfg, x)[:, 0], cache

    write = _write_slots(cache, lengths, uniform_lengths)
    if cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, cache, x, lengths, write)
    elif cfg.family == "audio":
        x = _decode_whisper(params, cfg, cache, x, lengths, write)
    else:
        x = _decode_decoder(params, cfg, cache, x, lengths, write, positions)
    cache = dict(cache, lengths=lengths + 1)
    return _lm_logits(params, cfg, x)[:, 0], cache


def _layer_write(write, i: int):
    """``_write_slots``'s (position, keep, old k, old v) for layer ``i``."""
    pos, keep, k_old, v_old = write
    return pos, keep, k_old[i], v_old[i]


def _decode_decoder(params, cfg, cache, x, lengths, write, positions):
    B = x.shape[0]
    # native sliding window always applies; the long-context window variant
    # only engages for caches past 64k (dense archs stay full-attention at 32k)
    window = cfg.attn_window
    if window is None and cfg.long_context_window is not None:
        if cache["k"].shape[2] > 65536:
            window = cfg.long_context_window

    if cfg.mrope:
        if positions is None:
            positions = lengths[None, :, None].expand(3, B, 1)
        angles = rope.mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                                   cfg.mrope_sections)
    else:
        angles = rope.rope_angles(lengths[:, None], cfg.head_dim, cfg.rope_theta)

    for i, lp in enumerate(_layers(params["layers"], cfg.num_layers)):
        h = _self_attention_decode(
            lp["attn"], cfg, layers.rms_norm(x, lp["ln1"], cfg.norm_eps),
            angles, cache["k"][i], cache["v"][i], lengths, _layer_write(write, i),
            window=window,
        )
        x = x + h
        h, _ = _ffn(lp, cfg, layers.rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + h
    return x


def _decode_hybrid(params, cfg, cache, x, lengths, write):
    """Each group's Mamba2 layers step their conv and ssm states in place;
    the shared block attends over its group's kv cache through K2."""
    angles = rope.rope_angles(lengths[:, None], cfg.head_dim, cfg.rope_theta)
    mamba = _layers(params["mamba_layers"], cfg.num_layers)
    shared = params["shared"]
    ae = cfg.attn_every
    for g in range(cfg.num_layers // ae):
        for i in range(g * ae, (g + 1) * ae):
            state = {key: cache[key][i] for key in ("conv", "ssm")}
            x, new = ssm.mamba2_block(mamba[i], x, head_dim=cfg.ssm_head_dim,
                                      ssm_state=cfg.ssm_state, cache=state)
            state["conv"].copy_(new["conv"])
            state["ssm"].copy_(new["ssm"])
        xg = x * params["group_gain"][g]
        h = _self_attention_decode(
            shared["attn"], cfg, layers.rms_norm(xg, shared["ln1"], cfg.norm_eps),
            angles, cache["k"][g], cache["v"][g], lengths, _layer_write(write, g),
            window=cfg.attn_window,
        )
        y = xg + h
        h, _ = _ffn(shared, cfg, layers.rms_norm(y, shared["ln2"], cfg.norm_eps))
        x = y + h
    return x


def _decode_whisper(params, cfg, cache, x, lengths, write):
    """K2 over the self-attention cache, then K2 over the encoder's k/v.

    The position embedding is read at the clamped position: a free slot of a
    continuous batch at or past max_seq gets NaN there, as the JAX package's
    out-of-range ``take`` gives it (its logits are NaN, its cache write is
    dropped, the other slots are unaffected)."""
    B = x.shape[0]
    S = cache["k"].shape[2]
    pe = _sinusoid(lengths.clamp(max=S - 1), cfg.d_model)
    pe = torch.where((lengths < S)[:, None], pe, float("nan")).to(x.dtype)
    x = x + pe[:, None]
    enc_len = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32, device=x.device)
    for i, lp in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        h = _self_attention_decode(
            lp["attn"], cfg, layers.rms_norm(x, lp["ln1"], cfg.norm_eps),
            None, cache["k"][i], cache["v"][i], lengths, _layer_write(write, i),
            window=None,
        )
        x = x + h
        q = _q_proj(lp["xattn"], cfg, layers.rms_norm(x, lp["lnx"], cfg.norm_eps))
        o = decode_attention(q[:, 0], cache["xk"][i], cache["xv"][i], enc_len)
        x = x + layers.dense(o.reshape(B, 1, -1), lp["xattn"]["wo"])
        h, _ = _ffn(lp, cfg, layers.rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + h
    return x
