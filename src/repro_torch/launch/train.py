"""Training launcher: train one architecture on the synthetic LM data.

The counterpart of the JAX package's ``launch/train.py``, on one device:
the GPU, or the CPU with ``--device cpu``.  The weights start random, drawn
from seed 0.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 50 --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.devices import resolve_device
from repro_torch.models import transformer
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the device to train on: the GPU unless 'cpu'")
    ns = ap.parse_args(argv)

    device = resolve_device(ns.device)
    arch = ns.arch + ("-smoke" if ns.smoke and not ns.arch.endswith("-smoke")
                      else "")
    cfg = get_arch(arch)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={name}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=ns.seq,
                      batch_size=ns.batch)
    data = SyntheticLM(dcfg).batches()
    opt_cfg = AdamWConfig(lr=ns.lr, warmup_steps=max(ns.steps // 10, 1),
                          total_steps=ns.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat=ns.remat,
                              microbatches=ns.microbatches, device=device)
    params = transformer.init_params(cfg, 0, device)
    opt_state = init_opt_state(params)
    t0 = time.time()
    for step in range(ns.steps):
        params, opt_state, stats = step_fn(params, opt_state, next(data))
        if step % ns.log_every == 0 or step == ns.steps - 1:
            print(f"step {step:>5} loss {float(stats['loss']):.4f} "
                  f"lr {float(stats['lr']):.2e} "
                  f"gnorm {float(stats['grad_norm']):.3f}")
    dt = time.time() - t0
    toks = ns.steps * ns.batch * ns.seq
    print(f"done: {toks} tokens in {dt:.1f}s ({toks/dt:.0f} tok/s)")
    if ns.ckpt_dir:
        path = f"{ns.ckpt_dir}/step_{ns.steps}"
        n = save_checkpoint(path, params, opt_state, ns.steps,
                            {"arch": cfg.name})
        print(f"checkpoint {path} ({n/1e6:.1f} MB)")


if __name__ == "__main__":
    main()
