"""Model assembly: the dense, moe and vlm decoder-only transformers and the
ssm family (rwkv6).

The counterpart of the JAX package's ``models/transformer.py``.  Parameters
are a nested dict of tensors with the JAX package's keys, each layer leaf
stacked on a leading (L, ...) axis; the layers run as a Python loop over
views of those leaves.  The hybrid and audio families come with their own
slices and raise ``NotImplementedError`` here.

Entry points, used by serving:
  init_params(cfg, seed, device)             -> params
  params_from_numpy(tree, cfg, device)       -> params (from the JAX package's)
  forward(params, cfg, batch)                -> dict(logits (B, S, V) f32, ...)
  init_cache(cfg, batch, max_seq, device=)   -> cache
  prefill(params, cfg, batch, max_seq)       -> (logits_last, cache)
  decode_step(params, cfg, cache, tokens)    -> (logits, cache)

``decode_step`` writes the new kv entries (or, for ssm, the WKV state and
the token shifts) into the cache tensors in place (the counterpart of the
JAX package donating its cache) and never reads a device value on the host,
so a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import resolve_device
from repro_torch.models import layers, moe, rope, ssm
from repro_torch.models.attention import attention, decode_attention
from repro_torch.serving.formats import QTensor

SUPPORTED_FAMILIES = ("dense", "moe", "vlm", "ssm")


def _check_family(cfg: ModelConfig):
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
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


def _layer_specs(cfg: ModelConfig):
    D = cfg.d_model
    if cfg.family == "ssm":
        return ssm.rwkv6_layer_specs(D, cfg.d_ff, cfg.ssm_head_dim)
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
    specs["layers"] = _leaves(_layer_specs(cfg), cfg.num_layers)
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


def _layer(tree, i: int):
    """Layer ``i``'s parameters: views into the stacked (L, ...) leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.wq[i], tree.scales[i])
    return tree[i]


def _layers(params, cfg: ModelConfig):
    return [_layer(params["layers"], i) for i in range(cfg.num_layers)]


# =============================================================================
# attention sublayer (shared by full-seq and decode paths)
# =============================================================================


def _qkv(p, cfg: ModelConfig, x, angles):
    B, S = x.shape[0], x.shape[1]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = layers.dense(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = layers.dense(x, p["wk"], p.get("bk")).reshape(B, S, K, hd)
    v = layers.dense(x, p["wv"], p.get("bv")).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
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


def _ffn(p, cfg: ModelConfig, x):
    """Returns (out, aux_loss or None)."""
    if cfg.is_moe:
        return moe.apply_moe_block(p["moe_block"], x, cfg)
    return layers.apply_mlp(p["mlp"], x, cfg.mlp), None


def _decoder_layer(p, cfg, x, angles, *, window):
    """Standard pre-norm decoder layer. Returns (x, (k, v), aux or None)."""
    h, kv = _self_attention_full(
        p["attn"], cfg, layers.rms_norm(x, p["ln1"], cfg.norm_eps),
        angles, window=window,
    )
    x = x + h
    h, aux = _ffn(p, cfg, layers.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + h, kv, aux


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


def _embed_in(params, cfg, batch):
    if batch.get("embeds") is not None:
        return batch["embeds"].to(cfg.torch_dtype)
    return layers.embed(batch["tokens"], params["embed"])


def _lm_logits(params, cfg, x, logits_for: str = "all"):
    if logits_for == "last":
        x = x[:, -1:]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return layers.unembed(x, table)


def forward(params, cfg: ModelConfig, batch, *, collect_kv: bool = False,
            logits_for: str = "all"):
    """Full-sequence scoring. Returns dict(logits, aux_loss [, kv | state]).

    logits_for="last" computes the LM head on the final position only (the
    prefill path: avoids materializing the (B, S, V) logits tensor).  With
    ``collect_kv`` an attention family returns ``kv`` (k, v) each
    (L, B, S, K, hd), and ssm returns ``state`` {"wkv", "tm_shift",
    "cm_shift"} stacked over layers.
    """
    _check_family(cfg)
    x = _embed_in(params, cfg, batch)
    B, S, _ = x.shape
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    collected = []
    if cfg.family == "ssm":
        for lp in _layers(params, cfg):
            x, state = ssm.rwkv6_block(lp, x, cfg.ssm_head_dim)
            if collect_kv:
                collected.append(state)
    else:
        angles = _rope_angles_for(cfg, batch, B, S, x.device)
        for lp in _layers(params, cfg):
            x, kv, aux = _decoder_layer(lp, cfg, x, angles, window=cfg.attn_window)
            if aux is not None:
                aux_total = aux_total + aux
            if collect_kv:
                collected.append(kv)
    out = {"logits": _lm_logits(params, cfg, x, logits_for), "aux_loss": aux_total}
    if collect_kv and cfg.family == "ssm":
        out["state"] = {key: torch.stack([st[key] for st in collected])
                        for key in ("wkv", "tm_shift", "cm_shift")}
    elif collect_kv:
        out["kv"] = (torch.stack([k for k, _ in collected]),
                     torch.stack([v for _, v in collected]))  # each (L,B,S,K,hd)
    return out


# =============================================================================
# serving: cache init / prefill / decode_step
# =============================================================================


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """Allocate the decode cache for ``batch_size`` slots of ``max_seq``.

    Attention families: k, v (L, B, max_seq, K, hd).  ssm: the WKV state
    (L, B, H, hd, hd) f32 and the token shifts (L, B, D); max_seq is unused.
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
    return {
        "k": torch.zeros((L, B, max_seq, K, hd), dtype=dt, device=device),
        "v": torch.zeros((L, B, max_seq, K, hd), dtype=dt, device=device),
        "lengths": lengths,
    }


def prefill(params, cfg: ModelConfig, batch, max_seq: int, cache=None):
    """Run the prompt through the model, build the decode cache.

    batch["tokens"]: (B, S) with S <= max_seq (uniform prompt length).
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
    elif (cache["wkv"].shape[1] != B if cfg.family == "ssm"
          else tuple(cache["k"].shape[1:3]) != (B, max_seq)):
        raise ValueError(f"prefill: the cache does not hold {B} slots of {max_seq}")
    if cfg.family == "ssm":
        for key, value in out["state"].items():
            cache[key].copy_(value)
    else:
        cache["k"][:, :, S:].zero_()
        cache["v"][:, :, S:].zero_()
        k, v = out["kv"]
        cache["k"][:, :, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :, :S] = v.to(cache["v"].dtype)
    cache["lengths"].fill_(S)
    return out["logits"][:, -1], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, positions=None,
                uniform_lengths: bool = False):
    """One decode step for every active slot.

    tokens: (B,) int (the previously sampled token). Returns (logits (B, V)
    f32, cache with lengths += 1); the tensors of the returned cache other
    than lengths are those of ``cache``, updated in place: the new kv entry
    of every layer, or for ssm every layer's WKV state and token shifts.

    uniform_lengths=True promises every slot is at the same position
    (lockstep decode pools): every slot writes at slot 0's position.
    """
    _check_family(cfg)
    lengths = cache["lengths"]
    B = tokens.shape[0]
    x = layers.embed(tokens, params["embed"])[:, None]  # (B,1,D)
    if cfg.family == "ssm":
        for i, lp in enumerate(_layers(params, cfg)):
            state = {key: cache[key][i] for key in ("wkv", "tm_shift", "cm_shift")}
            # the kernel writes the new WKV state over the old, in place
            x, new = ssm.rwkv6_block(lp, x, cfg.ssm_head_dim, cache=state,
                                     state_out=state["wkv"])
            state["tm_shift"].copy_(new["tm_shift"])
            state["cm_shift"].copy_(new["cm_shift"])
        cache = dict(cache, lengths=lengths + 1)
        return _lm_logits(params, cfg, x)[:, 0], cache

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

    pos, keep, k_old, v_old = _write_slots(cache, lengths, uniform_lengths)
    for i, lp in enumerate(_layers(params, cfg)):
        h = _self_attention_decode(
            lp["attn"], cfg, layers.rms_norm(x, lp["ln1"], cfg.norm_eps),
            angles, cache["k"][i], cache["v"][i], lengths,
            (pos, keep, k_old[i], v_old[i]), window=window,
        )
        x = x + h
        h, _ = _ffn(lp, cfg, layers.rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + h
    cache = dict(cache, lengths=lengths + 1)
    return _lm_logits(params, cfg, x)[:, 0], cache
