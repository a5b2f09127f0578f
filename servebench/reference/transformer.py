"""The ``transformer`` kind's plain float32 reference: the served decoder
models, dense and sparse-expert.

Written from the architectures' equations: token embedding; per layer a
pre-norm (RMSNorm) grouped-query attention with rotary positions (the
rotate-half form, the first half of each head against the second), causal and,
where the model has one, windowed; a pre-norm feed-forward, either squared
ReLU (minitron) or a top-k router over SwiGLU experts (mixtral); a final
RMSNorm and the output head.  The weights are the tensors the benchmark made,
read by the tree's key names; nothing of the program is imported, and nothing
the program derived from them is read.

Serving conventions the reference follows, because they are what a request
is served as (PERF.md, section 4):
- a prompt is zero-padded at its end to the next power of two, and the
  padded positions are part of the context (``padding.pad_length``, which
  every kind shares);
- an expert layer over a prompt drops, per expert, the routed rows past its
  capacity (``capacity`` below), taking each token's first choices before any
  second choice; a decoded token is never dropped.  With the capacity factor
  the configurations state (num_experts / experts_per_token) no row is ever
  dropped, in a prompt or in a decode batch, so a request's tokens do not
  depend on the other slots of its batch.

``Reference.run`` goes layer by layer over every sequence, so that one
layer's weights are in float32 at a time, and returns per sequence the
largest logit of each scored position and the logits of chosen tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from servebench.reference import quant


def capacity(tokens: int, experts: int, k: int, factor: float) -> int:
    c = int(tokens * k * factor / experts)
    return max(8, -(-c // 8) * 8)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotary(x, pos, theta):
    """x (T, heads, hd) rotated by positions pos (T,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: Optional[int]):
    """q (T, H, hd), k/v (T, K, hd): causal softmax attention, head h reading
    kv head h // (H / K)."""
    T, H, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(T, K, H // K, hd)
    s = torch.einsum("tkgd,skd->kgts", qg, k) * hd ** -0.5
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > i - window)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("kgts,skd->tkgd", p, v).reshape(T, H * hd)


def experts(x, w, k: int, factor: float, n_prompt: int, act=lambda t: t):
    """Top-k routed SwiGLU experts over x (T, D); the first ``n_prompt`` rows
    are one dispatch with a capacity, the rest each alone.  ``act`` rounds
    the left operand of each expert product."""
    E = w["router"].shape[1]
    probs = torch.softmax(x @ w["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(idx, dtype=torch.bool)
    if n_prompt > 0:
        C = capacity(n_prompt, E, k, factor)
        idx_km = idx[:n_prompt].T.reshape(-1)                  # first choices first
        onehot = (idx_km[:, None] == torch.arange(E, device=x.device)).to(torch.int64)
        pos = torch.gather(torch.cumsum(onehot, 0) - 1, 1, idx_km[:, None])[:, 0]
        keep[:n_prompt] = (pos < C).reshape(k, n_prompt).T
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slots = torch.nonzero((idx == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = act(x[rows])
        h = torch.nn.functional.silu(xe @ w["wi_gate"][e]) * (xe @ w["wi_up"][e])
        out.index_add_(0, rows, (act(h) @ w["wo"][e]) * gates[rows, slots, None])
    return out


class Reference:
    """The model of one configuration over the benchmark's weights.

    ``model``: the configuration file's ``model`` object; ``weights``: the
    weight tree the benchmark made; ``rules``: which rule of
    ``servebench.reference.quant`` each kind of weight is read with:
    ``matmul`` (attention, feed-forward and expert weights), ``head``, and
    ``norms`` (stacked layer norm gains, where the served format stores them
    quantized, as ``rsm_int8`` does; they are then rounded to bfloat16); and
    ``acts``, the rule of the other operand of every weight product
    (``quant.activations``).
    """

    MATMUL = ("wq", "wk", "wv", "wo", "wi", "wi_gate", "wi_up")

    def __init__(self, model: dict, weights: dict, rules: Dict[str, str]):
        self.m = model
        self.w = weights
        self.rules = rules

    def _layer(self, i: int) -> dict:
        def take(tree):
            out = {}
            for key, leaf in tree.items():
                if isinstance(leaf, dict):
                    out[key] = take(leaf)
                elif key in ("ln1", "ln2"):
                    out[key] = self._norms[key][i]
                elif key == "router":
                    out[key] = leaf[i].float()
                elif key in self.MATMUL:
                    out[key] = quant.apply(self.rules.get("matmul", "f32"), leaf[i])
                else:
                    out[key] = leaf[i].float()
            return out

        return take(self.w["layers"])

    def _stacked_norms(self) -> dict:
        rule = self.rules.get("norms")
        out = {}
        for key in ("ln1", "ln2"):
            leaf = self.w["layers"][key]
            out[key] = (quant.apply(rule, leaf).to(torch.bfloat16).float()
                        if rule else leaf.float())
        return out

    def run(self, seqs: Sequence[torch.Tensor], n_prompt: Sequence[int],
            n_scored: Sequence[int], select: Sequence[Sequence[torch.Tensor]] = (),
            head_rows: int = 512) -> List[dict]:
        """Score every sequence (int64 token ids, prompt then served tokens).

        Position ``n_prompt[i] - 1 + j`` predicts served token j, for j below
        ``n_scored[i]``.  Returns per sequence {"max": (n,), "argmax": (n,),
        "select": [(n,) logits of each id tensor of ``select[i]``]}.
        """
        m = self.m
        dev = seqs[0].device
        self._norms = self._stacked_norms()
        embed = self.w["embed"]
        xs = [embed[s].float() for s in seqs]
        H, K, hd = m["num_heads"], m["num_kv_heads"], m["d_model"] // m["num_heads"]
        if m.get("head_dim"):
            hd = m["head_dim"]
        window = m.get("attn_window")
        act = lambda t: quant.activations(self.rules.get("acts"), t)  # noqa: E731
        for layer in range(m["num_layers"]):
            w = self._layer(layer)
            for i, x in enumerate(xs):
                T = x.shape[0]
                pos = torch.arange(T, device=dev)
                a = w["attn"]
                h = act(rms_norm(x, self._norms["ln1"][layer], m["norm_eps"]))
                q = rotary((h @ a["wq"]).reshape(T, H, hd), pos, m["rope_theta"])
                k = rotary((h @ a["wk"]).reshape(T, K, hd), pos, m["rope_theta"])
                v = (h @ a["wv"]).reshape(T, K, hd)
                x = x + act(attention(q, k, v, window)) @ a["wo"]
                h = rms_norm(x, self._norms["ln2"][layer], m["norm_eps"])
                if "moe_block" in w:
                    x = x + experts(h, w["moe_block"]["moe"], m["experts_per_token"],
                                    m["capacity_factor"], n_prompt[i], act)
                elif m["mlp"] == "relu2":
                    mlp = w["mlp"]
                    x = x + act(torch.square(torch.relu(act(h) @ mlp["wi"]))) @ mlp["wo"]
                else:
                    mlp = w["mlp"]
                    h = act(h)
                    x = x + act(torch.nn.functional.silu(h @ mlp["wi_gate"])
                                * (h @ mlp["wi_up"])) @ mlp["wo"]
                xs[i] = x
            del w
        final = self.w["final_norm"].float()
        head = quant.apply(self.rules.get("head", "f32"), self.w["lm_head"])
        out = []
        for i, x in enumerate(xs):
            rows = x[n_prompt[i] - 1: n_prompt[i] - 1 + n_scored[i]]
            lmax, amax, picked = [], [], [[] for _ in (select[i] if select else ())]
            for r0 in range(0, rows.shape[0], head_rows):
                logits = act(rms_norm(rows[r0: r0 + head_rows], final, m["norm_eps"])) @ head
                mx, am = logits.max(dim=-1)
                lmax.append(mx)
                amax.append(am)
                for j, ids in enumerate(select[i] if select else ()):
                    ids = ids[r0: r0 + head_rows].to(dev, torch.int64)
                    picked[j].append(logits.gather(1, ids[:, None])[:, 0])
            out.append({"max": torch.cat(lmax), "argmax": torch.cat(amax),
                        "select": [torch.cat(p) for p in picked]})
        del head, xs
        return out
