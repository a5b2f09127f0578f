"""End-to-end training driver on the PyTorch port: train a ~100M-param
qwen3-family model for a few hundred steps on the synthetic LM pipeline,
with checkpointing, then serve the trained checkpoint and show the loss
actually dropped.

The counterpart of ``examples/train_small.py``.  The weights start random,
drawn from ``--seed``; it trains on the GPU unless ``--device cpu``.  The
checkpoint goes under ``examples_out/train_small`` unless ``--ckpt`` moves
it.

Run:  PYTHONPATH=src python examples/torch_train_small.py --steps 200
      PYTHONPATH=src python examples/torch_train_small.py --device cpu --steps 30 \\
          --d-model 128 --layers 2 --seq 64
"""

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core.engines import CompiledEngine
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM, eval_batches
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.trainer import batch_to, lm_loss, train_loop

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples_out")


def model_config(arch: str, d_model: int, layers: int):
    """The ~100M-param variant of ``arch``'s family that this script trains."""
    base = smoke_variant(get_arch(arch))
    return dataclasses.replace(
        base, name="qwen3-100m", num_layers=layers, d_model=d_model,
        num_heads=d_model // 64, num_kv_heads=max(2, d_model // 256),
        head_dim=64, d_ff=d_model * 4, vocab_size=32768,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(OUT_DIR, "train_small"))
    ap.add_argument("--device", default=None,
                    help="the device to train on: the GPU unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)

    cfg = model_config(ns.arch, ns.d_model, ns.layers)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{ns.steps} steps, seq={ns.seq}, batch={ns.batch}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=ns.seq,
                      batch_size=ns.batch)
    it = SyntheticLM(dcfg).batches()
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=ns.steps)

    params = init_params(cfg, ns.seed, device=device)
    t0 = time.time()
    res = train_loop(
        cfg, opt_cfg, it, ns.steps, params=params, log_every=max(ns.steps // 10, 1),
        device=device,
        callback=lambda r: print(
            f"  step {r['step']:>4}  loss {r['loss']:.4f}  "
            f"lr {r['lr']:.2e}  gnorm {r['grad_norm']:.2f}"
        ),
    )
    dt = time.time() - t0
    tokens = ns.steps * ns.seq * ns.batch
    print(f"trained {tokens} tokens in {dt:.1f}s ({tokens/dt:.0f} tok/s)")

    first, last = res["history"][0]["loss"], res["history"][-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f}")
    assert last < first, "training failed to reduce loss"

    path = os.path.join(ns.ckpt, f"step_{ns.steps}")
    nbytes = save_checkpoint(path, res["params"], res["opt_state"], ns.steps)
    print(f"checkpoint: {path} ({nbytes/1e6:.1f} MB)")

    # restore + eval + serve
    params, _, meta = load_checkpoint(path, res["params"], device=device)
    ev = eval_batches(dcfg, 2)
    with torch.no_grad():
        loss, _ = lm_loss(params, cfg, batch_to(ev[0], device))
    print(f"restored step={meta['step']}; eval loss {float(loss):.4f}")

    engine = CompiledEngine(cfg, params, max_seq=ns.seq + 32, device=device)
    out = engine.generate(ev[0]["tokens"][:1, :16], 8)
    print(f"served 8 tokens from the trained model: {out.tokens[0].tolist()}")
    return {"arch": cfg.name, "params": cfg.param_count(), "steps": ns.steps,
            "seq": ns.seq, "batch": ns.batch, "seconds": dt, "tokens_per_s": tokens / dt,
            "history": res["history"], "first_loss": first, "last_loss": last,
            "checkpoint": path, "checkpoint_bytes": nbytes, "restored_step": meta["step"],
            "eval_loss": float(loss), "tokens": out.tokens[0].tolist()}


if __name__ == "__main__":
    main()
