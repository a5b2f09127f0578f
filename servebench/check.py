"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests the run finished is
drawn from the seed: the one with the most served tokens, then others in an
order the seed shuffles, until ``SAMPLE_TOKENS`` served tokens are in it (at
most ``SAMPLE_REQUESTS`` requests).  The reference of the configuration's kind
(``servebench/reference/<kind>.py``, found by ``servebench/kinds.py``)
runs once over each prompt, padded as it was served, followed by its served
tokens, in float32 with TF32 off, and reads at each served token the gap by
which that token's logit lies below the reference's best logit there.

- ``gap_max``: the widest gap over the sample (the contract's number);
- ``gap_mean``: the mean gap over the sample.

Each is held to the limit its configuration file gives under ``check``.  The
control (``control_gaps``) reads the same gaps for the tokens that the
configuration's control precision puts first, at the same positions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from servebench import kinds
from servebench.reference.padding import pad_length

SAMPLE_TOKENS = 1024
SAMPLE_REQUESTS = 12


def sample(finished: Sequence[Tuple[int, np.ndarray]], seed: int) -> List[Tuple[int, np.ndarray]]:
    """(rid, served tokens) of the requests to compare."""
    if not finished:
        return []
    rng = np.random.default_rng(seed)
    longest = max(range(len(finished)), key=lambda i: (len(finished[i][1]), -i))
    order = [longest] + [i for i in rng.permutation(len(finished)) if i != longest]
    out, total = [], 0
    for i in order:
        if total >= SAMPLE_TOKENS or len(out) >= SAMPLE_REQUESTS:
            break
        out.append(finished[i])
        total += len(finished[i][1])
    return out


def _sequences(picked, prompts, device):
    import torch

    seqs, n_prompt, n_scored, served = [], [], [], []
    for rid, toks in picked:
        prompt = prompts[rid]
        padded = np.zeros(pad_length(len(prompt)), np.int64)
        padded[: len(prompt)] = prompt
        ids = np.concatenate([padded, np.asarray(toks, np.int64)[:-1]])
        seqs.append(torch.as_tensor(ids, device=device))
        n_prompt.append(len(padded))
        n_scored.append(len(toks))
        served.append(torch.as_tensor(np.asarray(toks, np.int64), device=device))
    return seqs, n_prompt, n_scored, served


def _reference_mode():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gaps(config: dict, weights: dict, picked, prompts, device,
         root: str = kinds.ROOT) -> Dict[str, float]:
    """The numbers compared, for the served tokens of ``picked``."""
    import torch

    _reference_mode()
    seqs, n_prompt, n_scored, served = _sequences(picked, prompts, device)
    Reference = kinds.reference(config, root)
    ref = Reference(config["model"], weights, config["reference"]["served"])
    with torch.no_grad():
        out = ref.run(seqs, n_prompt, n_scored, [[s] for s in served])
    g = torch.cat([o["max"] - o["select"][0] for o in out])
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "tokens": int(g.numel()), "requests": len(picked),
            "argmax_agree": float(torch.cat([o["argmax"] == s for o, s in zip(out, served)])
                                  .float().mean())}


def control_gaps(config: dict, weights: dict, picked, prompts, device,
                 root: str = kinds.ROOT) -> Dict[str, float]:
    """The same numbers for the tokens the control precision puts first."""
    import torch

    _reference_mode()
    seqs, n_prompt, n_scored, _ = _sequences(picked, prompts, device)
    Reference = kinds.reference(config, root)
    low = Reference(config["model"], weights, config["reference"]["control"])
    with torch.no_grad():
        firsts = [o["argmax"] for o in low.run(seqs, n_prompt, n_scored)]
        ref = Reference(config["model"], weights, config["reference"]["served"])
        out = ref.run(seqs, n_prompt, n_scored, [[f] for f in firsts])
    g = torch.cat([o["max"] - o["select"][0] for o in out])
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "tokens": int(g.numel()), "requests": len(picked)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    shown = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return all(numbers[k] <= v for k, v in limits.items()), shown
