#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line:
  build         nvcc builds every kernel of csrc/ for sm_90a
  kernels       each kernel against its plain PyTorch version on the card,
                at the main paths' shapes (minitron-4b, mixtral-8x7b,
                arctic-480b's moe decode, rwkv6-3b; zamba2-2.7b's head dim
                80 for K1 and K2; whisper-small's causal 1500-frame encoder
                and its non-causal cross attention (64 queries over 1500
                entries) for K1, and K2 over its 1500-entry cross cache) and
                the JAX package's sweep shapes, with its time, bound and the time of one
                PyTorch library call computing the same function where there
                is one; K1, K3 and K4 print the path their planner took (mma
                / wgmma / wmma / stream / fma), K2 its cache splits, K4 its D
                splits, K5 its plan (value columns per block, key-row groups
                per column).  K2 is also timed at the serve's own lengths
                (513..544) and K4 at the serve's own group sizes (4096 routed
                rows).  Each timed case is timed eagerly (ms, library_ms:
                CUDA events around the call) and as a CUDA-graph replay
                (graph_ms, library_graph_ms), with both factors, L2 flushed
                before each call by a 256 MB write, and the kernel also
                after a 256 MB read (ms_clean, graph_ms_clean: no dirty
                lines drain during the call); K3 at (4, 3072, 9216) adds
                torch.profiler's device time per kernel, and the phase the
                timing floor
  model_parity  minitron-4b, mixtral-8x7b, arctic-480b, rwkv6-3b, zamba2-2.7b
                and whisper-small (frames from --seed) -smoke in f32:
                prefill + 3 decode steps on the card (kernels) against
                the CPU (plain versions), rsm and rsm_int8; and minitron-4b-
                smoke in bf16 rsm_int8, the model-level check of K1's and K3's
                tensor-core and stream paths
  serve         full width, random weights from --seed: minitron-4b (32
                layers; rsm and rsm_int8), mixtral-8x7b (24 of its 32 layers:
                32 do not fit one 80 GB card), rwkv6-3b (32 layers),
                zamba2-2.7b (54 Mamba2 layers and 9 shared-block calls; rsm
                and rsm_int8) and whisper-small (12 + 12 layers, 64-token
                prompts, 64 new tokens, max_seq 448), bf16,
                each serving 8 requests through the binary codec with SI1
                (eager) and SI2 (CUDA graphs); the launch counters, reset
                before each arch, show the kernels on each path; then one
                more prefill of a batch and one SI2 decode step under
                torch.profiler give the device time per kernel (profile)
  schedule      the TD3 schedulers on the virtual-clock core: first
                minitron-4b-smoke in f32 (the four policies give one token
                stream under SI2; a free continuous-batch slot steps past
                max_seq inside the captured graph), then full-width
                minitron-4b (32 layers, bf16, max_seq 1024, random weights
                from --seed): a burst of 16 requests through dynamic and
                continuous batching on SI1 and SI2 (SI2's tokens must equal
                SI1's), and 48 Poisson requests at 10 req/s (512 prompt, 32
                new tokens) through the four policies on SI2 rsm,
                continuous batching on SI1 rsm and on SI2 rsm_int8.  Every
                dispatch executes on the card; the card's own energy
                (NVML) is read around each run and over 2 s of idle, and
                the run's timeline is billed again by a second core under
                those measured powers (schedule_run lines, then one
                schedule line)
  fleet         the replica fleet (routers, autoscaler, disaggregation,
                chaos, telemetry, monitor) on the card: first minitron-4b-
                smoke in f32 (two continuous-batching replicas of one SI2
                engine, alone and beside a dynamic-batching endpoint, give
                every request one SI1 core's tokens: each pool decodes its
                own slot cache), then full-width minitron-4b (bf16, max_seq
                1024, 512-token prompts, 32 new tokens) on two SI2 engines
                (rsm, rsm_int8) calibrated at B = 1..8: chat (32 Poisson
                requests at 6.67 req/s) and bulk (16 at 3.33) under
                round_robin and greenest with an autoscaler, chat
                disaggregated (1 prefill + 1 decode replica), chat on 2
                replicas with a crash of chat/r0 at 1.5 s, and chat on 2
                continuous-batching replicas.  Every dispatch executes; the
                card's energy is read around each run, and a second fleet
                replays the run's durations, billed at the measured draw,
                traced and monitored (one fleet_run line per run, then one
                fleet line)
  api           the declarative spec API (ServingSpec -> ServingSession):
                first minitron-4b-smoke, mixtral-8x7b-smoke, rwkv6-3b-smoke,
                zamba2-2.7b-smoke and whisper-small-smoke in f32, a burst of
                8 requests each through one spec on SI1,
                then on SI2 (with_override) with minitron-4b-smoke from
                rsm_int8 beside them: SI2's tokens equal SI1's, and K1-K5
                each launch inside the SI2 session's run(); then full-width
                minitron-4b (bf16, max_seq 1024, through the session's
                registry on disk in rsm and rsm_int8): chat (rsm, 16 Poisson
                requests at 6.67 req/s) and bulk (rsm_int8, 8 at 3.33)
                behind round_robin, one SI2 replica each, run_declared with
                the card's idle and calibration draw as the spec's power
                envelope, read by the card's energy counter beside the
                report's joules (api_run line; the green report and the
                roofline's derived entry on stderr); then
                python -m repro_torch.launch.serve at full width (api line)
  formats       rsm_int8 on disk -> load -> the same tokens as in memory;
                an 8-layer model serves rsm_int8 behind the norm-gain fence
  train         K1 with its lse and K1's backward against their plain
                versions at the training shapes (minitron-4b B2 S512;
                zamba2's dh 80, window 4096; whisper-small's encoder and
                cross attention), bf16 timed (SDPA forward, and forward +
                backward, as the yardsticks) and f32; K4's backward at
                mixtral-8x7b's training gate/up and down (C 320; uniform
                routing and empty experts) and at C 24, bf16 (timed beside
                torch.bmm, dx and dw also alone) and f32, and K5's backward
                at rwkv6-3b's (2, 40, 512, 64) and at T 200, f32, each run
                twice for identical bits; one f32 train step of minitron-4b,
                qwen3-8b, qwen2-vl-2b, zamba2-2.7b, whisper-small,
                mixtral-8x7b, arctic-480b and rwkv6-3b -smoke on the card
                against the CPU (loss 1e-4, gradients 1e-3, the step's update
                held to the AdamW rule; each family's kernels launched,
                forward and backward); full width, bf16, B 2, S 512, from
                random weights: minitron-4b (32 layers, 5 steps), rwkv6-3b
                (32 layers, 3 steps) and mixtral-8x7b (3 of 32 layers, 3
                steps): a warm-up step, then the AdamW steps under the
                card's energy counter, then one step under torch.profiler by
                part (one train_run line each; K1, K4, K5 and their
                backward kernels counted per layer and step);
                examples/torch_train_small.py at its defaults (a ~100M
                qwen3, 200 steps; its held-out loss must fall by 0.2, its
                loaded checkpoint serve through SI2 the tokens of the
                trained tree); python -m repro_torch.launch.train at smoke
                size
  examples      the twins of examples/*.py through their own main():
                quickstart (SI1 -> SI2 -> SI3 -> SI4) and serve_batched (SI3,
                continuous batching over the binary codec) at full-width
                minitron-4b (depth cut only if the temp disk cannot hold
                SI4's rsm upload), then green_comparison, sweep_decisions,
                serve_fleet, serve_disagg, serve_chaos, carbon_shift,
                serve_monitored and serve_traced at their default (smoke)
                arguments; one example line each (seconds, peak memory,
                launches eager and by graph replay); SI1, SI2 and SI3 must
                serve equal tokens, K1 and K2 launch inside both full-width
                twins, K3 inside sweep_decisions
  dryrun        first, in a process that holds nothing else yet: full-width
                minitron-4b on make_host_mesh() (1x1, this card): the
                dry-run's predicted peak bytes of a prefill (B 4 x 512), a
                decode step (B 4, a 1024-entry cache) and a train step (B 2
                x 512, bf16 optimizer state, remat) beside
                torch.cuda.max_memory_allocated() of the same step run with
                its kernels, the ratio within DRYRUN_RATIO (dryrun_card
                lines; the trace launches nothing); last, after the examples
                phase, the dry-run's sweep on the 16x16 and 2x16x16 meshes
                of fake ranks for minitron-4b, mixtral-8x7b, rwkv6-3b,
                zamba2-2.7b and whisper-small, every applicable shape, but
                zamba2-2.7b's train step on the 16x16 mesh (one dryrun line
                each: peak GB a device, fits_80gb, flops, collective bytes
                by kind; any failure fails the phase)
Then the kernel summary line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero.  Without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_FLUSH_BYTES = 256 << 20     # > 50 MB L2: each timed launch starts cold
KERNEL_SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:63"),
    "int8_matmul": ("src/repro_torch/kernels/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:40"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:41"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:56"),
    # the TPU kernels have no backward; these stand for the JAX package's VJPs:
    # K1's custom VJP rule, autodiff of the expert einsums and of the WKV lax.scan
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:102"),
    "moe_gmm_bwd": ("src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
                    "src/repro/models/moe.py:93"),
    "rwkv6_scan_bwd": ("src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                       "src/repro/models/ssm.py:116"),
}
BACKWARD_KERNELS = ("flash_attention_bwd", "moe_gmm_bwd", "rwkv6_scan_bwd")
# the kernels every serving path launches (the backward kernels only train)
SERVE_KERNELS = tuple(k for k in KERNEL_SOURCES if k not in BACKWARD_KERNELS)
# the serve phase's archs: (name, layers served or None for all, formats,
# what differs from phase_serve's defaults)
SERVE_ARCHS = (
    ("minitron-4b", None, ("rsm", "rsm_int8"), {}),
    # 32 layers hold 46.7 B parameters, 93.4 GB in bf16: more than one 80 GB
    # card; 24 layers hold 35.1 B, 70.2 GB
    ("mixtral-8x7b", 24, ("rsm",), {}),
    ("rwkv6-3b", None, ("rsm",), {}),
    ("zamba2-2.7b", None, ("rsm", "rsm_int8"), {}),
    # a transcription decoder sees short prompts; 448 is whisper-small's
    # published decoder context (n_text_ctx, arXiv:2212.04356)
    ("whisper-small", None, ("rsm",), dict(prompt_len=64, max_new=64, max_seq=448)),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- timing ----------------------------------------------------------------------


def l2_flush(clean: bool = False):
    """What runs before each timed call so that it finds L2 cold: a write of
    a 256 MB buffer (the readings of every earlier PR), or with ``clean`` a
    sum over it, which fills L2 with clean lines: the write's dirty lines
    drain to memory while the timed call runs, the sum's need no write-back."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    return (lambda: flush.sum(dtype=torch.int32)) if clean else flush.zero_


def time_ms(fn, iters: int = 10, graph: bool = False, clean: bool = False) -> float:
    """Median time of ``fn`` over ``iters`` runs, L2 flushed before each
    (``l2_flush(clean)``).

    Eagerly (the default): CUDA events around the call itself, so a kernel
    shorter than its host cost (a Python wrapper's checks, a library's
    dispatch) is timed as that cost.  With ``graph``: ``fn`` is captured once
    as a CUDA graph and its replays are timed, device time without the host's
    cost of issuing ``fn``, as SI2 replays its decode step."""
    import torch

    flush = l2_flush(clean)
    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    times = []
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_times(fn) -> dict:
    """ms and graph_ms after the writing flush, ms_clean and graph_ms_clean
    after the reading one."""
    return {"ms": time_ms(fn), "graph_ms": time_ms(fn, graph=True),
            "ms_clean": time_ms(fn, clean=True),
            "graph_ms_clean": time_ms(fn, graph=True, clean=True)}


def timed(case: dict, fn, plain, library, nbytes: float, flops: float,
          graph_library: bool = True) -> None:
    """Times of one case: the kernel's ``ms`` (eager) and ``graph_ms`` (CUDA-graph
    replay), each also after a reading flush (``ms_clean``, ``graph_ms_clean``),
    the plain version's (eager), the library call's both ways (only
    eagerly without ``graph_library``: an autograd call), the bound, and the
    factors ms / library_ms and graph_ms / library_graph_ms."""
    case.update(kernel_times(fn))
    case["plain_ms"] = time_ms(plain, 3)
    case["library_ms"] = case["library_graph_ms"] = None
    if library is not None:
        case["library_ms"] = time_ms(library)
        case["factor"] = case["ms"] / case["library_ms"]
        if graph_library:
            case["library_graph_ms"] = time_ms(library, graph=True)
            case["graph_factor"] = case["graph_ms"] / case["library_graph_ms"]
    case["bound_ms"], case["bound_by"] = bound(nbytes, flops, case["dtype"])


def timing_floor() -> dict:
    """Both methods' reading for one trivial kernel: the floor of every small time."""
    import torch

    small = torch.zeros(1, device="cuda")
    return {"ms": time_ms(lambda: small.add_(1)),
            "graph_ms": time_ms(lambda: small.add_(1), graph=True)}


def device_us(fns: dict, iters: int = 10, clean: bool = False) -> dict:
    """torch.profiler's device time of each kernel that ``fns`` launch, per
    call of its fn: the kernel's total over ``iters`` calls divided by
    ``iters`` (a kernel a call launches twice counts twice), L2 flushed
    before each call (``l2_flush(clean)``; the flush's own kernel left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = l2_flush(clean)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn in fns.values():
                flush()
                fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / iters for e in prof.key_averages()
            if e.self_device_time_total > 0 and "elementwise" not in e.key
            and "fill" not in e.key.lower() and not (clean and "reduce_kernel" in e.key)}


# the port's kernels by their CUDA function names (kernels/csrc/*.cu)
PORT_KERNEL_PREFIX = {"flash_attention": "flash_", "decode_attention": "decode_",
                      "int8_matmul": "int8_", "moe_gmm": "gmm_", "rwkv6_scan": "wkv_",
                      "flash_attention_bwd": "attn_bwd_", "moe_gmm_bwd": "gmmbwd_",
                      "rwkv6_scan_bwd": "wkvbwd_"}


def port_kernel(key: str):
    """Which port kernel a profiler event belongs to, or None (PyTorch's own)."""
    for name, prefix in PORT_KERNEL_PREFIX.items():
        if f"namespace)::{prefix}" in key:
            return name
    return None


def profile_device_us(fn) -> dict:
    """torch.profiler over one call of ``fn``: device microseconds summed per
    port kernel and for PyTorch's own kernels (``other``), their total, the
    wall time of the profiled call, and the largest of PyTorch's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by = dict.fromkeys(PORT_KERNEL_PREFIX, 0.0)
    other = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        name = port_kernel(e.key)
        if name is None:
            other[e.key[:70]] = other.get(e.key[:70], 0.0) + us
        else:
            by[name] += us
    by["other"] = sum(other.values())
    total = sum(by.values())
    return {"device_us": by, "device_us_total": total, "profiled_wall_us": wall_us,
            "share": {k: v / total for k, v in by.items()} if total else {},
            "top_other": dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])}


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: max |err| {err} beyond atol {atol} rtol {rtol}")
    return err


# -- phases ----------------------------------------------------------------------


def ptxas_report(log: str) -> dict:
    """{kernel: [registers, spill store bytes]} from nvcc's -Xptxas -v log;
    a kernel of the anonymous namespace as ``name<template args>``."""
    out, name, spill = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            n = re.match(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}(\d+)", name)
            if n:
                at = n.end() + int(n.group(1))
                args = [{"f": "f32", "13__nv_bfloat16": "bf16"}.get(t, d) for t, d in re.findall(
                    r"(?<=I)(f|13__nv_bfloat16)|Li(\d+)E", name[at:].split("EEv")[0])]
                name = name[n.end():at] + (f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            out[name] = [int(m.group(1)), spill]
            name = None
    return out


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(r["log"]) for name, r in report.items()}
    for name, kernels in ptxas.items():
        print(f"[nvcc {name}] registers, spill stores: {json.dumps(kernels)}", file=sys.stderr)
    out = {"phase": "build", "seconds": seconds,
           "nvcc_seconds": {k: r["seconds"] for k, r in report.items()},
           "built": {k: r["built"] for k, r in report.items()},
           "ptxas": ptxas, "gpu": smi()}
    emit(out)
    return out


def check_grad(name: str, got, want, atol: float, rtol: float) -> float:
    """check_close with ``atol`` scaled down to the largest |want| where that
    is below 1: attention gradients can be ~1e-3 (whisper's cross attention,
    T 1500), where a fixed atol would pass zeros."""
    return check_close(name, got, want, atol * min(1.0, float(want.float().abs().max())),
                       rtol)


def _tol(dtype):
    import torch

    return (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-4, 2e-4)


def phase_kernels(seed: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k2
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import int8_matmul as k3
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # K1: prefill attention, q/k/v in the model's (B, S, heads, dh) layout;
    # (B, H, K, Sq, T, dh, causal, window, timed)
    cases = []
    for (B, H, K, S, T, dh, causal, window, is_timed) in [
            (4, 24, 8, 512, 512, 128, True, None, True),      # minitron-4b prefill
            (4, 32, 8, 512, 512, 128, True, 4096, True),      # mixtral-8x7b (window 4096)
            (2, 6, 2, 96, 96, 32, True, 17, False),           # sweep shapes
            (1, 8, 8, 128, 128, 64, True, None, False),
            (4, 32, 32, 512, 512, 80, True, 4096, True),      # zamba2-2.7b shared block
            (4, 12, 12, 1500, 1500, 64, True, None, True),    # whisper-small encoder
            (4, 12, 12, 64, 1500, 64, False, None, True)]:    # whisper-small cross
        for dtype in (torch.bfloat16, torch.float32):
            qm = randn(B, S, H, dh, dtype=dtype)
            km = randn(B, T, K, dh, dtype=dtype)
            vm = randn(B, T, K, dh, dtype=dtype)
            q, k, v = qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            err = check_close(f"flash_attention {B,H,K,S,T,dh,causal,window} {dtype}", got,
                              want, *_tol(dtype))
            case = {"shape": [B, H, K, S, dh], "window": window,
                    "dtype": str(dtype)[6:], "path": k1.plan_call(q, k, v),
                    "max_abs_err": err}
            if (T, causal) != (S, True):
                case.update(kv_len=T, causal=causal)
            if is_timed:
                # every window here exceeds S, so SDPA (causal or not) computes
                # the same function
                es = qm.element_size()
                nbytes = (2 * B * S * H * dh + 2 * B * T * K * dh) * es
                flops = (4 * B * H * dh * S * (S + 1) / 2 if causal
                         else 4 * B * H * dh * S * T)
                timed(case, lambda: ops.flash_attention(q, k, v, causal=causal,
                                                        window=window),
                      lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                      lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=True),
                      nbytes, flops)
            emit_case("flash_attention", case)
            cases.append(case)
    results["flash_attention"] = cases

    # K2: decode attention over a (B, S, K, dh) cache, ragged lengths
    cases = []
    # minitron-4b decode, mixtral-8x7b decode (native window 4096), sweep shapes;
    # then minitron-4b at the serve phase's own lengths (512-token prompts,
    # 32 new tokens: 513..544 entries); zamba2-2.7b's shared block (dh 80, G 1,
    # window 4096) at the standard and the serve's lengths; whisper-small's
    # cross attention over its 1500 encoder entries
    for (B, K, G, S, dh, window, lens) in [
            (4, 8, 3, 1024, 128, None, None), (4, 8, 3, 1024, 128, 128, None),
            (4, 8, 4, 1024, 128, 4096, None),
            (3, 4, 1, 96, 64, None, None), (2, 2, 4, 128, 32, None, None),
            (4, 8, 3, 1024, 128, None, [513, 524, 535, 544]),
            (4, 32, 1, 1024, 80, 4096, None), (4, 32, 1, 1024, 80, 4096, [513, 524, 535, 544]),
            (4, 12, 1, 1500, 64, None, [1500] * 4)]:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(B, K, G, dh, dtype=dtype)
            kc = randn(B, S, K, dh, dtype=dtype).transpose(1, 2)
            vc = randn(B, S, K, dh, dtype=dtype).transpose(1, 2)
            lengths = torch.tensor(lens or [S, S * 3 // 4 + 9, S // 2 + 1, 100][:B],
                                   dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, kc, vc, lengths, window=window)
            want = ref.decode_attention_ref(q, kc, vc, lengths, window=window)
            err = check_close(f"decode_attention {B,K,G,S,dh,window} {dtype}", got, want,
                              *_tol(dtype))
            case = {"shape": [B, K, G, S, dh], "window": window,
                    "lengths": lengths.tolist(), "dtype": str(dtype)[6:],
                    "splits": k2.plan(B, K, S, sms).splits, "max_abs_err": err}
            if (S, window) == (1024, None) or dh == 80 or S == 1500:
                # zamba2's window of 4096 exceeds every length: the masked
                # SDPA computes the same function
                es = q.element_size()
                n_read = int(lengths.sum())
                nbytes = (2 * q.numel() + 2 * n_read * K * dh) * es + 4 * B
                flops = 4 * n_read * K * G * dh
                mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])
                mask = mask[:, None, None, :]
                qh = q.reshape(B, K * G, 1, dh)
                timed(case, lambda: ops.decode_attention(q, kc, vc, lengths, window=window),
                      lambda: ref.decode_attention_ref(q, kc, vc, lengths, window=window),
                      lambda: F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask,
                                                             enable_gqa=True),
                      nbytes, flops)
            emit_case("decode_attention", case)
            cases.append(case)
    results["decode_attention"] = cases

    # K3: int8 weight-only GEMM at every dense() shape of a minitron-4b
    # layer (wq/wo, wk/wv, MLP wi, MLP wo): M=1 and 4 (decode, the stream
    # path), 100 (a short prefill) and 2048 = B*S (prefill, wgmma); then the
    # ragged (300, 520, 136), which TMA cannot address (fma), and the JAX
    # sweep's (16, 64, 32).  bf16 is timed; f32 (the fma path) is checked.
    cases = []
    shapes = [(M, D, N) for M in (1, 4, 100, 2048)
              for (D, N) in ((3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072))]
    for (M, D, N) in shapes + [(300, 520, 136), (16, 64, 32)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(M, D, dtype=dtype)
            wq, scales = ops.quantize_int8(randn(D, N, dtype=torch.float32) * D ** -0.5)
            got = ops.int8_matmul(x, wq, scales)
            want = ref.int8_matmul_ref(x, wq, scales)
            tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-3, 1e-3)
            err = check_close(f"int8_matmul {M,D,N} {dtype}", got, want, *tol)
            p = k3.plan_call(x, wq)
            case = {"shape": [M, D, N], "dtype": str(dtype)[6:], "path": p.path,
                    "splits": p.splits, "max_abs_err": err}
            if dtype == torch.bfloat16 and (M, D, N) in shapes:
                es = x.element_size()
                nbytes = (M * D + M * N) * es + D * N + 4 * N
                flops = 2 * M * D * N
                w_deq = (wq.float() * scales[None, :]).to(dtype)
                timed(case, lambda: ops.int8_matmul(x, wq, scales),
                      lambda: ref.int8_matmul_ref(x, wq, scales),
                      lambda: torch.matmul(x, w_deq), nbytes, flops)
                if (M, D, N) == (4, 3072, 9216):
                    # the decode path's kernels (stream, split sum) and cuBLAS's
                    fns = {"k3": lambda: ops.int8_matmul(x, wq, scales),
                           "library": lambda: torch.matmul(x, w_deq)}
                    case["device_us"] = device_us(fns)
                    case["device_us_clean"] = device_us(fns, clean=True)
            emit_case("int8_matmul", case)
            cases.append(case)
    results["int8_matmul"] = cases
    # K3's share of one rsm_int8 layer: wq, wk, wv, wo (attention) and wi, wo
    # (MLP); the prefill at M=2048 runs eagerly, SI2's decode step at M=4 is
    # a graph replay
    def per_layer(M, key):
        t = {tuple(c["shape"][1:]): c[key] for c in cases if c["shape"][0] == M and key in c}
        return 2 * t[(3072, 3072)] + 2 * t[(3072, 1024)] + t[(3072, 9216)] + t[(9216, 3072)]
    layer = per_layer(2048, "ms")
    results["moe_gmm"] = _moe_gmm_cases(seed, randn)
    results["rwkv6_scan"] = _rwkv6_scan_cases(seed, randn)
    floor = timing_floor()
    print(f"[timing floor] {json.dumps(floor)}", file=sys.stderr, flush=True)
    emit({"phase": "kernels", "cases": results, "timing_floor": floor,
          "int8_matmul_ms_per_prefill_layer": layer,
          "int8_matmul_ms_per_prefill_32_layers": 32 * layer,
          "int8_matmul_graph_ms_per_decode_32_layers": 32 * per_layer(4, "graph_ms")})
    return results


def _moe_gmm_cases(seed: int, randn) -> list:
    """K4 at mixtral-8x7b's prefill (B=4 x 512 tokens, C=640) and decode (4
    tokens, C=8) shapes with ragged group sizes, at the prefill shapes with
    the serve's own group sizes, at arctic-480b's decode shape (8 routed rows
    on 8 of 128 experts; bf16 only: its float32 weight alone is 17.8 GB), at
    mixtral's training shapes (C=320, a uniform router's 2048 rows; bf16),
    and at the JAX package's sweep shapes; each case prints its path and the mma
    path's D splits.  Bound: only the live rows of x and the weights of
    experts with live rows are read; the whole output is written."""
    import numpy as np
    import torch

    from repro_torch.kernels import moe_gmm as k4
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed)
    prefill_gs = rng.integers(0, 641, 8)
    prefill_gs[:2] = (0, 640)                      # an idle and a full expert
    decode_gs = np.array([2, 0, 3, 1, 0, 0, 2, 0])  # 8 routed rows, 4 idle experts
    # the serve's prefill: 4 x 512 tokens, top-2, so 4096 routed rows over 8
    # experts, each clamped at the capacity 640 (models/moe.py:capacity)
    serve_gs = np.minimum(rng.multinomial(4096, [1 / 8] * 8), 640)
    arctic_gs = np.zeros(128, dtype=np.int64)
    arctic_gs[rng.choice(128, 8, replace=False)] = 1   # 4 tokens, top-2
    # mixtral-8x7b's training batch (B 2 x S 512, top-2: C 320), the sizes a
    # uniform router gives, as in _moe_gmm_bwd_cases
    train_gs = np.minimum(np.random.default_rng(seed + 22).multinomial(2048, [1 / 8] * 8), 320)
    shapes = [  # (E, C, D, F, group sizes, timed or not, f32 tolerance or None)
        (8, 640, 4096, 14336, prefill_gs, True, 1e-3),   # gate / up, prefill
        (8, 640, 14336, 4096, prefill_gs, True, 1e-3),   # down, prefill
        (8, 640, 4096, 14336, serve_gs, True, 1e-3),     # gate / up, serve-sized
        (8, 640, 14336, 4096, serve_gs, True, 1e-3),     # down, serve-sized
        (8, 8, 4096, 14336, decode_gs, True, 1e-3),      # gate / up, decode
        (8, 8, 14336, 4096, decode_gs, True, 1e-3),      # down, decode
        (128, 8, 7168, 4864, arctic_gs, True, None),     # arctic gate / up, decode
        (8, 320, 4096, 14336, train_gs, True, None),     # gate / up, training
        (8, 320, 14336, 4096, train_gs, True, None),     # down, training
        (2, 32, 64, 48, np.arange(2) * 13 % 33, False, 1e-4),
        (4, 64, 96, 128, np.arange(4) * 13 % 65, False, 1e-4),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for (E, C, D, F, gs_np, is_timed, f32_tol) in shapes:
        gs = torch.tensor(gs_np, dtype=torch.int32, device="cuda")
        for dtype in (torch.bfloat16,) + ((torch.float32,) if f32_tol else ()):
            x = randn(E, C, D, dtype=dtype)
            w = (randn(E, D, F, dtype=torch.float32) * D ** -0.5).to(dtype)
            got = ops.moe_gmm(x, w, gs)
            want = ref.moe_gmm_ref(x, w, gs)
            tol = 5e-2 if dtype == torch.bfloat16 else f32_tol
            err = check_close(f"moe_gmm {E,C,D,F} {dtype}", got, want, tol, tol)
            p = k4.plan_call(x, w, sms)
            case = {"shape": [E, C, D, F], "group_sizes": gs_np.tolist(),
                    "dtype": str(dtype)[6:], "path": p.path, "splits": p.splits,
                    "max_abs_err": err}
            if is_timed and dtype == torch.bfloat16:
                es = x.element_size()
                rows = int(gs_np.sum())
                live_experts = int((gs_np > 0).sum())
                nbytes = (rows * D + live_experts * D * F + E * C * F) * es + 4 * E
                flops = 2 * rows * D * F
                live = torch.arange(C, device="cuda")[None, :, None] < gs[:, None, None]
                xz = torch.where(live, x, 0)
                timed(case, lambda: ops.moe_gmm(x, w, gs), lambda: ref.moe_gmm_ref(x, w, gs),
                      lambda: torch.bmm(xz, w), nbytes, flops)
            emit_case("moe_gmm", case)
            cases.append(case)
    return cases


def _rwkv6_scan_cases(seed: int, randn) -> list:
    """K5 at rwkv6-3b's prefill (B=4, H=40, T=512, dh=64) and decode (T=1)
    shapes, f32 as the model feeds it, and at the JAX package's sweep shapes
    in f32 and bf16.  r/k/v/w are (B, H, T, dh) views of (B, T, H, dh) memory,
    as the model passes them.  Each case prints K5's plan: value columns per
    block (jb) and key-row groups per column.  No single PyTorch call
    computes the recurrence, so there is no library time."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as k5

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    shapes = [((4, 40, 512, 64), (torch.float32,), True),
              ((4, 40, 1, 64), (torch.float32,), True),
              ((1, 2, 32, 16), (torch.float32, torch.bfloat16), False),
              ((2, 3, 48, 32), (torch.float32, torch.bfloat16), False)]
    cases = []
    for (B, H, T, dh), dtypes, is_timed in shapes:
        for dtype in dtypes:
            r, k, v = ((randn(B, T, H, dh, dtype=torch.float32) * 0.5).to(dtype)
                       .transpose(1, 2) for _ in range(3))
            w = torch.sigmoid(randn(B, T, H, dh, dtype=torch.float32)).to(dtype).transpose(1, 2)
            u = randn(H, dh, dtype=torch.float32) * 0.3
            s0 = randn(B, H, dh, dh, dtype=torch.float32) * 0.1
            out, sf = ops.rwkv6_scan(r, k, v, w, u, s0)
            want_out, want_sf = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
            tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
            err = max(check_close(f"rwkv6_scan out {B,H,T,dh} {dtype}", out, want_out,
                                  tol, tol),
                      check_close(f"rwkv6_scan state {B,H,T,dh} {dtype}", sf, want_sf,
                                  2e-4, 2e-4))
            case = {"shape": [B, H, T, dh], "dtype": str(dtype)[6:],
                    "plan": k5.plan(B, H, dh, sms)._asdict(), "max_abs_err": err}
            if is_timed:
                es = r.element_size()
                n = B * H * T * dh
                nbytes = 5 * n * es + 4 * H * dh + 2 * 4 * B * H * dh * dh
                # per step and (b, h): out = v * sum_i(r u k) + r @ S is
                # 2 dh^2 + 5 dh, S <- w * S + k v^T is 3 dh^2
                flops = B * H * T * (5 * dh * dh + 5 * dh)
                timed(case, lambda: ops.rwkv6_scan(r, k, v, w, u, s0),
                      lambda: ref.rwkv6_scan_ref(r, k, v, w, u, s0), None, nbytes, flops)
            emit_case("rwkv6_scan", case)
            cases.append(case)
    return cases


def emit_case(kernel: str, case: dict) -> None:
    """One kernel case on stderr as it completes: path, error, times, factor."""
    keys = ("arch", "shape", "window", "group_sizes", "dtype", "path", "splits", "plan",
            "max_abs_err", "ms", "graph_ms", "ms_clean", "graph_ms_clean", "library_ms",
            "library_graph_ms", "bound_ms", "factor", "graph_factor", "device_us",
            "device_us_clean", "kernel_device_ms", "kernel_device_ms_clean",
            "library_device_ms", "dq_splits",
            "library_fwd_bwd_ms", "library_fwd_bwd_device_ms", "device_factor", "ds_final",
            "of_bound", "dx", "dw", "schedule", "forward_ms", "forward_with_checkpoints_ms")
    print(f"[{kernel}] " + json.dumps({k: case[k] for k in keys if k in case}),
          file=sys.stderr, flush=True)


def _tree_to(tree, device):
    from repro_torch.serving.formats import QTensor

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.wq.to(device), tree.scales.to(device))
    return tree.to(device)


def _parity_run(cfg, p_cpu, prompt, max_seq: int, what: str, atol: float = 1e-3,
                frames=None) -> float:
    """Prefill + 3 decode steps on the card and on the CPU; max |logit diff|.
    ``frames``: the audio encoder's input, (B, encoder_seq, D)."""
    import torch

    from repro_torch.models import transformer

    p_gpu = _tree_to(p_cpu, "cuda")
    extra = {} if frames is None else {"frames": frames}
    with torch.no_grad():
        l_cpu, c_cpu = transformer.prefill(p_cpu, cfg, {"tokens": prompt, **extra}, max_seq)
        l_gpu, c_gpu = transformer.prefill(p_gpu, cfg, {"tokens": prompt.cuda(),
                                                        **_tree_to(extra, "cuda")}, max_seq)
        errs = [check_close(f"{what} prefill", l_gpu.cpu(), l_cpu, atol, 0.0)]
        tok = torch.argmax(l_cpu, -1).to(torch.int32)
        for step in range(3):
            l_cpu, c_cpu = transformer.decode_step(p_cpu, cfg, c_cpu, tok)
            l_gpu, c_gpu = transformer.decode_step(p_gpu, cfg, c_gpu, tok.cuda())
            errs.append(check_close(f"{what} decode {step}", l_gpu.cpu(), l_cpu, atol, 0.0))
            tok = torch.argmax(l_cpu, -1).to(torch.int32)
    return max(errs)


def phase_model_parity(seed: int) -> dict:
    """The -smoke archs in f32: kernels on the card vs plain versions on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params

    out = {"phase": "model_parity", "dtype": "float32", "atol": 1e-3, "archs": {}}
    rng = np.random.default_rng(seed)
    for arch in ("minitron-4b-smoke", "mixtral-8x7b-smoke", "arctic-480b-smoke",
                 "rwkv6-3b-smoke", "zamba2-2.7b-smoke", "whisper-small-smoke"):
        cfg = get_arch(arch)
        cpu_params = transformer.init_params(cfg, seed, device="cpu")
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32))
        frames = (torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
            if cfg.family == "audio" else None)
        res = {}
        for fmt in ("rsm", "rsm_int8"):
            p_cpu = quantize_params(cpu_params) if fmt == "rsm_int8" else cpu_params
            res[fmt] = {"max_abs_err": _parity_run(cfg, p_cpu, prompt, 32, f"{arch} {fmt}",
                                                   frames=frames)}
            if arch == "mixtral-8x7b-smoke":
                # 96 tokens in a 128-entry cache: its native window of 32 takes the
                # decode path's window-gather branch through K2
                long = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96),
                                                     dtype=np.int32))
                res[fmt]["window_gather_max_abs_err"] = _parity_run(
                    cfg, p_cpu, long, 128, f"{arch} {fmt} window")
        out["archs"][arch] = res
    out["bf16"] = _bf16_parity(seed, rng)
    emit(out)
    return out


# bf16 logits of minitron-4b-smoke (|logit| up to ~4) move by ~0.036 between
# bf16 and float32 on the CPU with the same int8 weights; the card and the CPU
# both compute in bf16 but round at different points (the card rounds P to
# bf16 in K1 and sums in another order), so their difference is of that
# order.  0.1 leaves room for it; a wrong tile or fragment gives errors of O(1).
BF16_PARITY_ATOL = 0.1


def _bf16_parity(seed: int, rng) -> dict:
    """minitron-4b-smoke in bf16 rsm_int8: the card's K1 (mma), K3 (wgmma at
    prefill, stream at decode) and K2 against the CPU's plain versions on the
    same bf16 weights, prefill + 3 decode steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params

    cfg = dataclasses.replace(get_arch("minitron-4b-smoke"), dtype="bfloat16")
    p_cpu = quantize_params(transformer.init_params(cfg, seed, device="cpu"))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32))
    ops.reset_launch_counts()
    err = _parity_run(cfg, p_cpu, prompt, 32, "minitron-4b-smoke bf16 rsm_int8",
                      atol=BF16_PARITY_ATOL)
    launches = ops.launch_counts()
    if launches["flash_attention"] == 0 or launches["int8_matmul"] == 0:
        raise AssertionError(f"bf16 parity run launched {launches}")
    return {"arch": cfg.name, "format": "rsm_int8", "dtype": "bfloat16",
            "atol": BF16_PARITY_ATOL, "max_abs_err": err, "launches": launches}


def _serve(engine, prompts, max_new: int, batch: int):
    """Requests cross the binary codec in and out; returns ({rid: tokens}, results)."""
    import numpy as np

    from repro_torch.serving.codecs import BinaryCodec
    from repro_torch.serving.request import Request, Response

    codec = BinaryCodec()
    wire = [codec.encode_request(rid, p, max_new) for rid, p in enumerate(prompts)]
    answers, results = {}, []
    for start in range(0, len(wire), batch):
        reqs = []
        for data in wire[start:start + batch]:
            rid, toks, n_new = codec.decode_request(data)
            reqs.append(Request(rid=rid, prompt=toks, max_new_tokens=n_new))
        res = engine.generate(np.stack([r.prompt for r in reqs]), reqs[0].max_new_tokens)
        results.append(res)
        for r, toks in zip(reqs, res.tokens):
            resp = Response(rid=r.rid, tokens=toks, arrival_s=0.0, start_s=0.0,
                            first_token_s=res.prefill_s, done_s=res.total_s)
            rid, back = codec.decode_response(codec.encode_response(resp.rid, resp.tokens))
            answers[rid] = back
    return answers, results


def _qtensor_leaves(tree) -> int:
    """QTensor leaves of one layer's tree: one K3 launch each per forward."""
    from repro_torch.serving.formats import QTensor

    if isinstance(tree, dict):
        return sum(_qtensor_leaves(v) for v in tree.values())
    return int(isinstance(tree, QTensor))


def _launches_per_pass(cfg, tree) -> tuple:
    """({kernel: launches per prefill}, {kernel: launches per decode step})."""
    L = cfg.num_layers
    zero = dict.fromkeys(KERNEL_SOURCES, 0)
    if cfg.family == "hybrid":
        # the shared block runs once per group of attn_every Mamba2 layers;
        # the Mamba2 leaves are multiplied with @, never through K3
        G = L // cfg.attn_every
        int8 = G * _qtensor_leaves(tree["shared"])
        return (dict(zero, flash_attention=G, int8_matmul=int8),
                dict(zero, decode_attention=G, int8_matmul=int8))
    if cfg.family == "audio":
        # prefill: encoder self, decoder self and cross attention (K1); a
        # step: decoder self and cross attention (K2), and the cross
        # attention's q and o only (its k/v are cached at prefill)
        E, dec = cfg.encoder_layers, tree["dec_layers"]
        xkv = _qtensor_leaves({k: dec["xattn"][k] for k in ("wk", "wv")})
        return (dict(zero, flash_attention=E + 2 * L, int8_matmul=E * _qtensor_leaves(
                    tree["enc_layers"]) + L * _qtensor_leaves(dec)),
                dict(zero, decode_attention=2 * L,
                     int8_matmul=L * (_qtensor_leaves(dec) - xkv)))
    attn = cfg.family != "ssm"
    int8 = L * _qtensor_leaves(tree["layers"])
    moe_gmm = 3 * L if cfg.is_moe else 0          # gate, up, down per layer
    rwkv6 = L if cfg.family == "ssm" else 0
    prefill = dict(zero, flash_attention=L if attn else 0, int8_matmul=int8,
                   moe_gmm=moe_gmm, rwkv6_scan=rwkv6)
    step = dict(prefill, flash_attention=0, decode_attention=L if attn else 0)
    return prefill, step


def _combine(a: dict, na: int, b: dict, nb: int) -> dict:
    return {k: a[k] * na + b[k] * nb for k in a}


def _serve_arch(cfg, formats, seed: int, n_requests: int, prompt_len: int,
                max_new: int, batch: int, max_seq: int) -> dict:
    """One arch's path: every format through SI1 and SI2, counters from 0."""
    import numpy as np
    import torch

    from repro_torch.core.engines import CompiledEngine, EagerEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed, device="cuda")
    trees = {fmt: quantize_params(params) if fmt == "rsm_int8" else params
             for fmt in formats}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len, dtype=np.int32)
               for _ in range(n_requests)]
    n_batches = -(-n_requests // batch)
    steps = max_new - 1

    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "requests": n_requests, "prompt_len": prompt_len,
           "max_new_tokens": max_new, "batch": batch, "max_seq": max_seq,
           "init_s": init_s, "init_max_memory_allocated": torch.cuda.max_memory_allocated(),
           "params_bytes": sum(t.numel() * t.element_size() for t in _tensors(params)),
           "runs": {}}
    tokens = {}
    graph_launches = {k: 0 for k in ops.launch_counts()}
    profiled = {k: 0 for k in ops.launch_counts()}
    out["profile"] = {}
    ops.reset_launch_counts()
    for fmt, tree in trees.items():
        per_prefill, per_step = _launches_per_pass(cfg, tree)
        # SI1: every launch goes through the wrappers' counters
        eng = EagerEngine(cfg, tree, max_seq)
        with torch.no_grad():
            logits, cache = eng.prefill_one(np.stack(prompts[:batch]))
            logits2, _ = eng.decode_batch(cache, torch.argmax(logits, -1))
        if not (torch.isfinite(logits).all() and torch.isfinite(logits2).all()):
            raise AssertionError(f"{cfg.name} {fmt}: non-finite logits")
        del cache
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        answers, results = _serve(eng, prompts, max_new, batch)
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = _combine(per_prefill, n_batches, per_step, steps * n_batches)
        if counts != want:
            raise AssertionError(f"{cfg.name} {fmt} SI1 launches {counts} != {want}")
        tokens[(fmt, "SI1")] = answers
        stats = _run_stats(results, batch, max_new, counts)
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["runs"][f"{fmt}/SI1"] = stats
        del eng
        torch.cuda.empty_cache()

        # SI2: prefill eager, decode replays one captured graph per batch size
        torch.cuda.reset_peak_memory_stats()
        eng2 = CompiledEngine(cfg, tree, max_seq)
        capture_s = eng2.warmup(batch, prompt_len)
        g = eng2.graphs[batch]
        replays0 = g.replays
        before = ops.launch_counts()
        answers2, results2 = _serve(eng2, prompts, max_new, batch)
        counts2 = {k: v - before[k] for k, v in ops.launch_counts().items()}
        replays = g.replays - replays0
        if g.launches_per_replay != per_step or replays != steps * n_batches:
            raise AssertionError(f"{cfg.name} {fmt} SI2 graph {g.launches_per_replay} "
                                 f"x {replays}")
        # outside the graph only the eager prefills launch: no eager decode step
        want2 = _combine(per_prefill, n_batches, per_step, 0)
        if counts2 != want2:
            raise AssertionError(f"{cfg.name} {fmt} SI2 launches outside the graph "
                                 f"{counts2} != {want2}")
        for rid, toks in answers2.items():
            if not np.array_equal(toks, answers[rid]):
                raise AssertionError(f"{cfg.name} {fmt}: SI2 tokens of request {rid} "
                                     "differ from SI1")
        tokens[(fmt, "SI2")] = answers2
        stats = _run_stats(results2, batch, max_new, counts2)
        stats.update(capture_s=capture_s, graph_replays=replays,
                     launches_per_replay=g.launches_per_replay,
                     max_memory_allocated=torch.cuda.max_memory_allocated())
        out["runs"][f"{fmt}/SI2"] = stats
        for k, n in g.launches_per_replay.items():
            graph_launches[k] += n * g.replays
        # one more prefill of a batch and one SI2 decode step (a replay) under
        # torch.profiler: measured device time per kernel; their launches are
        # left out of the counts above
        before = ops.launch_counts()
        with torch.no_grad():
            batch_tokens = np.stack(prompts[:batch])
            prof_prefill = profile_device_us(lambda: eng2.prefill_one(batch_tokens))
            logits, cache = eng2.prefill_one(batch_tokens)
            tok = torch.argmax(logits, -1).to(torch.int32)
            prof_decode = profile_device_us(lambda: eng2.decode_batch(cache, tok))
        for k, v in ops.launch_counts().items():
            profiled[k] += v - before[k]
        out["profile"][fmt] = {"prefill": prof_prefill, "si2_decode_step": prof_decode}
        if cfg.family == "hybrid" and fmt == formats[0]:
            out["mamba2_profile"] = _mamba2_profile(cfg, tree, batch, prompt_len,
                                                    prof_prefill)
        print(f"[profile {cfg.name} {fmt}] " + json.dumps(out["profile"][fmt]),
              file=sys.stderr, flush=True)
        del eng2, g, cache, logits
        torch.cuda.empty_cache()
    if "rsm_int8" in trees:
        a = np.stack([tokens[("rsm", "SI1")][r] for r in range(n_requests)])
        b = np.stack([tokens[("rsm_int8", "SI1")][r] for r in range(n_requests)])
        out["int8_token_agreement"] = float((a == b).mean())
    out["answered"] = len(tokens[(formats[-1], "SI2")])
    out["launches"] = {k: v - profiled[k] for k, v in ops.launch_counts().items()}
    out["graph_replay_launches"] = graph_launches
    del params, trees
    return out


def _mamba2_profile(cfg, params, batch: int, prompt_len: int, prefill: dict) -> dict:
    """The Mamba2 layers' part of one hybrid prefill: torch.profiler's device
    time of one layer (layer 0 on a random (B, S, D) input) and of its
    chunked SSD recurrence alone, times the model's layers, over the whole
    prefill's device time."""
    import torch

    from repro_torch.models import ssm, transformer

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    B, T, nh = batch, prompt_len, cfg.d_inner // cfg.ssm_head_dim
    hd, S = cfg.ssm_head_dim, cfg.ssm_state

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    x = (rand(B, T, cfg.d_model) * 2 - 1).to(cfg.torch_dtype)
    layer = transformer._layers(params["mamba_layers"], 1)[0]
    xh, Bt, Ct, dt = rand(B, T, nh, hd) - 0.5, rand(B, T, S) - 0.5, rand(B, T, S) - 0.5, rand(B, T, nh)
    h0 = torch.zeros((B, nh, hd, S), device="cuda")
    with torch.no_grad():
        block = profile_device_us(lambda: ssm.mamba2_block(layer, x, head_dim=hd, ssm_state=S))
        ssd = profile_device_us(lambda: ssm.ssd_chunked(xh, Bt, Ct, -dt, dt, h0))
    L, total = cfg.num_layers, prefill["device_us_total"]
    out = {"layer_device_us": block["device_us_total"], "ssd_device_us": ssd["device_us_total"],
           "layers_share_of_prefill": L * block["device_us_total"] / total,
           "ssd_share_of_prefill": L * ssd["device_us_total"] / total,
           "layer_top": block["top_other"], "ssd_top": ssd["top_other"]}
    print(f"[mamba2 {cfg.name}] " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def phase_serve(seed: int, n_requests: int = 8, prompt_len: int = 512,
                max_new: int = 32, batch: int = 4, max_seq: int = 1024) -> dict:
    """The main paths at full width, one arch after the other."""
    import torch

    from repro_torch.configs import get_arch

    out = {"phase": "serve", "archs": {}}
    for name, layers, formats, changes in SERVE_ARCHS:
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        run = dict(dict(prompt_len=prompt_len, max_new=max_new, max_seq=max_seq), **changes)
        res = _serve_arch(cfg, formats, seed, n_requests, batch=batch, **run)
        if layers is not None:
            res["depth_cut"] = (f"{layers} of {get_arch(name).num_layers} layers: the "
                                "full depth does not fit one 80 GB card in bf16")
        out["archs"][name] = res
        emit(dict(res, phase="serve_arch"))
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(a["launches"][k] for a in out["archs"].values())
                       for k in KERNEL_SOURCES}
    out["graph_replay_launches"] = {
        k: sum(a["graph_replay_launches"][k] for a in out["archs"].values())
        for k in KERNEL_SOURCES}
    emit({"phase": "serve", "launches": out["launches"],
          "graph_replay_launches": out["graph_replay_launches"]})
    return out


def _run_stats(results, batch, max_new, counts) -> dict:
    prefill = [r.prefill_s for r in results]
    decode = [r.decode_s / (r.n_steps - 1) for r in results]
    total = sum(r.total_s for r in results)
    return {"prefill_ms": [1e3 * s for s in prefill],
            "decode_ms_per_step": [1e3 * s for s in decode],
            "tokens_per_s": batch * max_new * len(results) / total,
            "launches": counts}


def phase_formats(seed: int) -> dict:
    """rsm_int8 through the disk on the card; the fence at 8 layers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.engines import EagerEngine
    from repro_torch.models import transformer
    from repro_torch.serving import formats

    out = {"phase": "formats"}
    rng = np.random.default_rng(seed)
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    for layers in (2, 8):
        cfg = dataclasses.replace(get_arch("minitron-4b-smoke"), num_layers=layers)
        params = transformer.init_params(cfg, seed, device="cuda")
        prompt = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            nbytes = formats.save_rsm(params, tmp, quantize=True)
            loaded = formats.load_rsm(params, tmp, as_qtensor=True, device="cuda")
        in_mem = formats.quantize_params(params)
        got = EagerEngine(cfg, loaded, 64).generate(prompt, 8).tokens
        want = EagerEngine(cfg, in_mem, 64).generate(prompt, 8).tokens
        if not np.array_equal(got, want):
            raise AssertionError(f"{layers} layers: rsm_int8 from disk != in memory")
        ln1 = loaded["layers"]["ln1"]
        if not isinstance(ln1, torch.Tensor):
            raise AssertionError("norm gains must load dequantized")
        out[f"layers_{layers}"] = {"bytes": nbytes, "tokens_equal": True,
                                   "ln1_dtype": str(ln1.dtype)}
    emit(out)
    return out


# -- the card's energy and the schedule phase ---------------------------------------

NVML_SUCCESS, NVML_ERROR_NOT_SUPPORTED = 0, 3


class CardEnergy:
    """The board's energy through NVML (ctypes on NVIDIA's
    libnvidia-ml.so.1): its cumulative energy counter
    (nvmlDeviceGetTotalEnergyConsumption, mJ) or, where the board reports
    that as not supported, its power (nvmlDeviceGetPowerUsage, mW) sampled
    by a thread at 50 Hz and integrated.  The power is sampled either way,
    as a cross-check of the counter.  The card's energy, not the host's:
    NVML's device ``index`` must be torch's (their names agree)."""

    SAMPLE_S = 0.02

    def __init__(self, index: int = 0):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                ("nvmlDeviceGetName", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetPowerUsage", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        lib.nvmlErrorString.restype = ctypes.c_char_p
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(self._handle)),
                    "nvmlDeviceGetHandleByIndex_v2")
        name = ctypes.create_string_buffer(96)
        self._check(lib.nvmlDeviceGetName(self._handle, name, 96), "nvmlDeviceGetName")
        self.name = name.value.decode()
        import torch

        if self.name != torch.cuda.get_device_name(index):
            raise AssertionError(f"NVML device {index} is {self.name}, torch's is "
                                 f"{torch.cuda.get_device_name(index)}")
        mj = ctypes.c_ulonglong()
        rc = lib.nvmlDeviceGetTotalEnergyConsumption(self._handle, ctypes.byref(mj))
        if rc == NVML_SUCCESS:
            self.method = "nvml_total_energy_counter"
        elif rc == NVML_ERROR_NOT_SUPPORTED:
            self.method = "nvml_power_sampled_50hz"
        else:
            self._check(rc, "nvmlDeviceGetTotalEnergyConsumption")

    def _check(self, rc: int, what: str) -> None:
        if rc != NVML_SUCCESS:
            raise RuntimeError(f"{what}: NVML error {rc} "
                               f"({self._lib.nvmlErrorString(rc).decode()})")

    def _energy_mj(self) -> int:
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(self._handle,
                                                                  ctypes.byref(mj)),
                    "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value

    def _power_w(self) -> float:
        mw = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetPowerUsage(self._handle, ctypes.byref(mw)),
                    "nvmlDeviceGetPowerUsage")
        return mw.value / 1e3

    def measure(self, fn):
        """``fn()`` with the card synchronised before and after; returns (its
        result, {"j", "s", "w": the card's joules, seconds and mean draw over
        the call, "sampled_j", "samples": the sampled power's integral})."""
        import torch

        samples, errors = [], []
        stop = threading.Event()

        def sample():
            try:
                while True:
                    samples.append(self._power_w())
                    if stop.wait(self.SAMPLE_S):
                        return
            except RuntimeError as e:
                errors.append(e)

        counter = self.method == "nvml_total_energy_counter"
        torch.cuda.synchronize()
        sampler = threading.Thread(target=sample, daemon=True)
        e0 = self._energy_mj() if counter else 0
        t0 = time.perf_counter()
        sampler.start()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            t1 = time.perf_counter()
            stop.set()
            sampler.join()
        e1 = self._energy_mj() if counter else 0
        if errors:
            raise errors[0]
        seconds = t1 - t0
        sampled_j = sum(samples) / len(samples) * seconds
        joules = (e1 - e0) / 1e3 if counter else sampled_j
        return out, {"j": joules, "s": seconds, "w": joules / seconds,
                     "sampled_j": sampled_j, "samples": len(samples)}

    def close(self) -> None:
        self._check(self._lib.nvmlShutdown(), "nvmlShutdown")


def _recorded_steps_class():
    """A StepTimeCache that never hits while it records, so every dispatch
    of a live run executes on the card, and keeps each measured duration in
    call order; its ``replaying()`` copy hands them back in that order, so a
    second SchedulerCore re-runs that very timeline without the card.  Its
    estimates (``estimate_generate``, ``has_shape``) answer from what it was
    seeded with (``seed_from``), never from what it records."""
    from repro_torch.serving.stepcache import StepTimeCache

    class RecordedSteps(StepTimeCache):
        def __init__(self, log=None):
            super().__init__()
            self.log = {} if log is None else log
            self.pos = None if log is None else {}

        def get(self, key):
            if self.pos is None:
                self.misses += 1
                return None
            i = self.pos[key] = self.pos.get(key, 0) + 1
            self.hits += 1
            return self.log[key][i - 1]

        def put(self, key, payload):
            if self.pos is None:
                self.log.setdefault(key, []).append(tuple(float(x) for x in payload))

        def replaying(self):
            return RecordedSteps(self.log)

        def executed(self) -> int:
            return sum(len(v) for v in self.log.values())

        def executed_s(self) -> float:
            return sum(sum(d) for v in self.log.values() for d in v)

    return RecordedSteps


def _engine_graphs(engine) -> list:
    """Every decode graph of an engine: generate's, one per batch size, and
    the slot-pool graphs ``decode_cache`` captured (none under SI1)."""
    return list(getattr(engine, "graphs", {}).values()) + list(getattr(engine, "slot_graphs", []))


def _prefill_graphs(engine) -> list:
    """Every B = 1 prefill graph of an engine, one a prompt length (none
    under SI1)."""
    return list(getattr(engine, "prefill_graphs", {}).values())


def _graph_replays(engine) -> dict:
    # simlint: allow(id-key) -- this process's graphs, keyed within one run
    return {id(g): g.replays for g in _engine_graphs(engine) + _prefill_graphs(engine)}


def _replayed_since(engine, replays0: dict, launches: dict) -> tuple:
    """({decode graph id: replays since ``replays0``}, the kernel launches
    the replays of every graph made, by kernel, the prefill graphs'
    replays since ``replays0``)."""
    decode, prefill = _engine_graphs(engine), _prefill_graphs(engine)
    since = {id(g): g.replays - replays0.get(id(g), 0) for g in decode + prefill}  # simlint: allow(id-key)
    graph_launches = {k: sum(g.launches_per_replay[k] * since[id(g)] for g in decode + prefill)
                      for k in launches}
    replayed = {id(g): since[id(g)] for g in decode}  # simlint: allow(id-key)
    return replayed, graph_launches, sum(since[id(g)] for g in prefill)


SCHEDULE_POLICY = dict(max_batch=8, timeout_ms=20.0, max_seq=1024, ttft_slo_ms=200.0)


def _timeline(m) -> list:
    return [(r.rid, r.arrival_s, r.start_s, r.first_token_s, r.done_s) for r in m.responses]


def _schedule_run(card, engine, kind: str, workload, wl_name: str, fmt: str,
                  idle_w: float) -> tuple:
    """One live run of ``kind`` on ``engine`` (every dispatch executes),
    read by the card's energy; then its timeline billed again under the
    measured draw (active) and idle draw.  Returns (the run's line, tokens)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.core import SchedulerCore
    from repro_torch.serving.scheduler import make_policy

    L = engine.cfg.num_layers
    steps = _recorded_steps_class()()
    core = SchedulerCore(engine, make_policy(kind, **SCHEDULE_POLICY), step_cache=steps)
    replays0 = _graph_replays(engine)
    before = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    live, card_e = card.measure(lambda: core.run(workload()))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    replayed, graph_launches, prefill_replays = _replayed_since(engine, replays0, launches)
    if steps.hits:
        raise AssertionError(f"{kind}: {steps.hits} dispatches replayed in a live run")
    billed = SchedulerCore(engine, make_policy(kind, **SCHEDULE_POLICY),
                           step_cache=steps.replaying(), active_power_w=card_e["w"],
                           idle_power_w=idle_w).run(workload())
    if _timeline(billed) != _timeline(live):
        raise AssertionError(f"{kind}: the re-billed timeline differs from the live run")
    tokens = {r.rid: [int(t) for t in r.tokens] for r in live.responses}
    n_tok = live.total_tokens
    line = {
        "phase": "schedule_run", "workload": wl_name, "policy": kind, "engine": engine.name,
        "format": fmt, "requests": len(live.responses), "tokens": n_tok,
        "virtual_makespan_s": max(r.done_s for r in live.responses),
        "ttft_p50_s": live.ttft_percentile(50), "ttft_p95_s": live.ttft_percentile(95),
        "latency_p50_s": live.latency_percentile(50),
        "latency_p95_s": live.latency_percentile(95),
        "tokens_per_s": live.throughput_tok_s,
        "dispatches_executed": steps.executed(), "dispatches_replayed": steps.hits,
        "prefills": launches["flash_attention"] // L + prefill_replays,
        "decode_steps": launches["decode_attention"] // L + sum(replayed.values()),
        "graph_replays": sum(replayed.values()),
        "wall_s": card_e["s"], "active_s": billed.meter.active_s,
        "idle_s": billed.meter.idle_s,
        "energy_method": card.method, "card_j": card_e["j"], "card_mean_w": card_e["w"],
        "card_sampled_j": card_e["sampled_j"], "power_samples": card_e["samples"],
        "card_j_per_token": card_e["j"] / n_tok, "idle_w": idle_w,
        "meter_j_per_token": billed.energy_per_token_j,
        "meter_active_j_per_token": billed.meter.active_j / n_tok,
        "meter_j_per_request": billed.energy_per_request_j,
        "meter_g_per_token": billed.gco2_per_token,
        "max_memory_allocated": peak,
        "launches": launches, "graph_replay_launches": graph_launches,
    }
    emit(line)
    return line, tokens


def _cb_tokens(engine, workload, num_slots: int, max_seq: int) -> dict:
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    m = ContinuousBatchScheduler(engine, num_slots=num_slots, max_seq=max_seq).run(workload)
    return {r.rid: [int(t) for t in r.tokens] for r in m.responses}


def _schedule_smoke_f32(seed: int) -> dict:
    """minitron-4b-smoke in f32 on the card: the reference test's workload
    (4 requests, 8-token prompts, 3 new tokens) gives one token stream
    through the four policies under SI2; and a free continuous-batch slot
    steps past max_seq inside SI2's graph (its write is dropped, no device
    assert) while the busy slot's tokens stay SI1's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.engines import CompiledEngine, EagerEngine
    from repro_torch.models import transformer
    from repro_torch.serving.request import Request, synth_workload
    from repro_torch.serving.scheduler import POLICIES, make_scheduler

    cfg = get_arch("minitron-4b-smoke")
    params = transformer.init_params(cfg, seed, device="cuda")
    si2 = CompiledEngine(cfg, params, 64)
    streams = {}
    for kind in POLICIES:
        sched = make_scheduler(kind, si2, max_batch=4, timeout_ms=10.0, max_seq=64)
        if kind == "continuous_batch":
            sched = make_scheduler(kind, si2, max_batch=2, max_seq=64)
        m = sched.run(synth_workload(4, 8, 3, cfg.vocab_size, rate_per_s=1000, seed=3))
        streams[kind] = {r.rid: [int(t) for t in r.tokens] for r in m.responses}
    for kind, stream in streams.items():
        if stream != streams["realtime"] or len(stream) != 4:
            raise AssertionError(f"f32 smoke: {kind}'s tokens {stream} != realtime's "
                                 f"{streams['realtime']}")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 16)]

    def overflow():
        return [Request(rid=0, prompt=prompts[0], max_new_tokens=20),
                Request(rid=1, prompt=prompts[1], max_new_tokens=2)]

    want = _cb_tokens(EagerEngine(cfg, params, 32), overflow(), 2, 32)
    si2_32 = CompiledEngine(cfg, params, 32)
    got = _cb_tokens(si2_32, overflow(), 2, 32)
    torch.cuda.synchronize()
    free_len = int(si2_32.slot_graphs[0].cache["lengths"][1])
    if got != want or free_len <= 32:
        raise AssertionError(f"f32 smoke: the overflow case gave {got} (SI1 {want}), "
                             f"the free slot's length {free_len}")
    return {"arch": cfg.name, "dtype": cfg.dtype, "policies_equal": True,
            "tokens": streams["realtime"], "overflow_free_slot_length": free_len,
            "overflow_tokens_equal_si1": True}


def phase_schedule(seed: int, prompt_len: int = 512, max_new: int = 32) -> dict:
    """The TD3 schedulers at full width on the card, with its own energy."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.engines import CompiledEngine, EagerEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params
    from repro_torch.serving.request import synth_workload
    from repro_torch.serving.scheduler import POLICIES

    t_phase = time.perf_counter()
    out = {"phase": "schedule", "smoke_f32": _schedule_smoke_f32(seed)}
    cfg = get_arch("minitron-4b")
    max_seq = SCHEDULE_POLICY["max_seq"]
    card = CardEnergy()
    params = transformer.init_params(cfg, seed, device="cuda")
    engines = {("SI1", "rsm"): EagerEngine(cfg, params, max_seq),
               ("SI2", "rsm"): CompiledEngine(cfg, params, max_seq),
               ("SI2", "rsm_int8"): CompiledEngine(cfg, quantize_params(params), max_seq)}
    # graph captures and first calls stay outside every timed and energy window
    t0 = time.perf_counter()
    for (si, _), eng in engines.items():
        if si == "SI2":
            for B in range(1, SCHEDULE_POLICY["max_batch"] + 1):
                eng.warmup(B, prompt_len)
        logits, _ = eng.prefill_one(np.zeros((1, prompt_len), np.int32))
        eng.decode_batch(eng.decode_cache(SCHEDULE_POLICY["max_batch"], max_seq),
                         torch.argmax(logits, -1).expand(SCHEDULE_POLICY["max_batch"]))
    torch.cuda.synchronize()
    out.update(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, dtype=cfg.dtype,
               max_seq=max_seq, policy_args=SCHEDULE_POLICY, warmup_s=time.perf_counter() - t0,
               energy_method=card.method, gpu=smi())
    _, idle = card.measure(lambda: time.sleep(2.0))
    out["idle"] = idle
    V = cfg.vocab_size

    def burst():
        return synth_workload(16, prompt_len, max_new, V, rate_per_s=1e6, seed=seed)

    def poisson():
        return synth_workload(48, prompt_len, max_new, V, rate_per_s=10.0, seed=seed)

    ops.reset_launch_counts()
    graph_launches = dict.fromkeys(ops.launch_counts(), 0)
    runs = []

    def run(si, fmt, kind, workload, name):
        line, tokens = _schedule_run(card, engines[(si, fmt)], kind, workload, name, fmt,
                                     idle["w"])
        for k, n in line["graph_replay_launches"].items():
            graph_launches[k] += n
        runs.append({k: line[k] for k in (
            "workload", "policy", "engine", "format", "tokens", "ttft_p50_s", "ttft_p95_s",
            "latency_p95_s", "tokens_per_s", "card_mean_w", "card_j_per_token",
            "meter_j_per_token", "meter_active_j_per_token", "decode_steps",
            "graph_replays")})
        return tokens

    for kind in ("dynamic_batch", "continuous_batch"):
        si1 = run("SI1", "rsm", kind, burst, "burst16")
        si2 = run("SI2", "rsm", kind, burst, "burst16")
        differ = [rid for rid in si1 if si2.get(rid) != si1[rid]]
        if differ or len(si2) != 16:
            raise AssertionError(f"burst {kind}: SI2's tokens differ from SI1's for "
                                 f"requests {differ}")
    for kind in POLICIES:
        run("SI2", "rsm", kind, poisson, "poisson48@10")
    run("SI1", "rsm", "continuous_batch", poisson, "poisson48@10")
    run("SI2", "rsm_int8", "continuous_batch", poisson, "poisson48@10")
    launches = ops.launch_counts()
    for k in ("flash_attention", "decode_attention", "int8_matmul"):
        if launches[k] == 0:
            raise AssertionError(f"schedule phase: {k} was never launched ({launches})")
    card.close()
    del engines, params
    torch.cuda.empty_cache()
    out.update(burst_si2_tokens_equal_si1=True, runs=runs, launches=launches,
               graph_replay_launches=graph_launches, seconds=time.perf_counter() - t_phase)
    emit(out)
    return out


# -- the fleet phase -----------------------------------------------------------------

FLEET_POLICY = dict(max_batch=8, timeout_ms=20.0, max_seq=1024)
FLEET_CRASH = ("chat/r0", 1.5)               # (replica, virtual s) of the chaos run
# the replays' monitor: window, budgets, and (TTFT ms, deadline s) per SLO class
FLEET_MONITOR = dict(window_s=0.25, incident_gap_s=1.0, budgets=(
    dict(name="crashes", kind="crashes", budget=1.0, horizon_s=60.0, fast_window_s=0.5,
         slow_window_s=1.0, page_burn=50.0, warn_burn=10.0),
    dict(name="chat-ttft", kind="slo", slo_class="interactive", objective=0.9,
         fast_window_s=0.5, slow_window_s=1.0, page_burn=8.0, warn_burn=2.0),
    dict(name="joules", kind="joules", budget=3000.0, horizon_s=10.0, fast_window_s=0.5,
         slow_window_s=1.0, page_burn=10.0, warn_burn=2.0),
    dict(name="loss", kind="loss", budget=50.0, horizon_s=10.0, fast_window_s=0.5,
         slow_window_s=1.0, page_burn=10.0, warn_burn=2.0)))
FLEET_SLO_TARGETS = {("chat", "interactive"): (500.0, 0.0)}


@contextlib.contextmanager
def _replica_caches(make):
    """While open, ReplicaFleet builds each replica's step cache with
    ``make()`` in place of ``StepTimeCache()``, in spawn order."""
    from repro_torch.serving import fleet as fleet_mod

    saved = fleet_mod.StepTimeCache
    fleet_mod.StepTimeCache = make
    try:
        yield
    finally:
        fleet_mod.StepTimeCache = saved


def _slot_captures(engines) -> dict:
    """The SI2 slot-pool graphs the engines captured so far (F5: one per
    slot cache handed out at once): count, capture seconds and bytes."""
    graphs = [g for e in engines for g in getattr(e, "slot_graphs", [])]
    return {"count": len(graphs), "seconds": sum(g.capture_s for g in graphs),
            "cache_bytes": sum(g.cache_bytes for g in graphs)}


def _make_fleet(run: dict, calib: dict, powers=None, telemetry=None, monitor=None):
    """The fleet ``run`` describes; ``powers`` = (active W, idle W) of every
    replica, else the meter's defaults."""
    from repro_torch.serving.chaos import (ChaosEvent, ChaosRuntime, ChaosSpec,
                                           RetryRuntime, RetrySpec)
    from repro_torch.serving.fleet import Autoscaler, EndpointSpec, ReplicaFleet

    kw = {}
    if run.get("crash"):
        target, t_s = run["crash"]
        kw["chaos"] = ChaosRuntime.from_spec(ChaosSpec(events=(
            ChaosEvent(kind="crash", t_s=t_s, target=target),)))
        kw["retry"] = RetryRuntime.from_spec(RetrySpec())
    fleet = ReplicaFleet(router=run["router"], autoscaler=Autoscaler(**run["autoscaler"]),
                         telemetry=telemetry, monitor=monitor, **kw)
    for ep in run["endpoints"]:
        ep = dict(ep)
        fmt = ep.pop("format")
        if powers is not None:
            ep.update(active_power_w=powers[0], idle_power_w=powers[1])
        fleet.add_endpoint(EndpointSpec(warm_cache=calib[fmt], **ep))
    return fleet


def _fleet_run(card, run: dict, calib: dict, idle_w: float, engines: list) -> dict:
    """One live fleet run (every dispatch executes on the card, each
    replica's step cache records its measured durations), read by the
    card's energy; then a second fleet, whose replicas replay those
    durations, bills the same timeline at the measured draw (active) and
    idle draw, traced and monitored.  Returns the run's line."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.admission import kv_cache_bytes
    from repro_torch.serving.monitor import BudgetSpec, MonitorRuntime, MonitorSpec
    from repro_torch.serving.telemetry import TraceRecorder, to_perfetto, validate_trace

    name = run["name"]
    cfg = run["endpoints"][0]["engine"].cfg
    L = cfg.num_layers
    Recorder = _recorded_steps_class()
    recorders = []

    def record():
        recorders.append(Recorder())
        return recorders[-1]

    replays0 = [_graph_replays(e) for e in engines]
    slots0 = _slot_captures(engines)
    with _replica_caches(record):
        fleet = _make_fleet(run, calib)
        spawned = len(fleet.replicas)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        live, card_e = card.measure(lambda: fleet.run(run["workloads"]()))
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    replayed, prefill_replays, graph_launches = 0, 0, dict.fromkeys(launches, 0)
    for e, r0 in zip(engines, replays0):
        rep, gl, pre = _replayed_since(e, r0, launches)
        replayed += sum(rep.values())
        prefill_replays += pre
        for k, n in gl.items():
            graph_launches[k] += n
    if any(r.hits for r in recorders):
        raise AssertionError(f"fleet {name}: dispatches replayed in a live run")
    live_timeline = _timeline(live.fleet)
    tokens = {r.rid: [int(t) for t in r.tokens] for r in live.fleet.responses}
    live_replicas = [(r.name, r.created_s, r.ready_s, r.stopped_s) for r in fleet.replicas]
    handoff_bytes = sum(e["kv_bytes"] for e in fleet.handoff_events)
    handoffs = len(fleet.handoff_events)
    captured = _slot_captures(engines)
    # the live fleet goes first: its slot caches return to their engine's
    # free list, so the replay's continuous-batching replicas capture nothing
    del fleet
    gc.collect()

    rec = TraceRecorder()
    mon = MonitorRuntime(MonitorSpec(
        enabled=True, window_s=FLEET_MONITOR["window_s"],
        incident_gap_s=FLEET_MONITOR["incident_gap_s"],
        budgets=tuple(BudgetSpec(**b) for b in FLEET_MONITOR["budgets"])),
        rec, FLEET_SLO_TARGETS)
    replaying = iter([r.replaying() for r in recorders])
    with _replica_caches(lambda: next(replaying)):
        billed_fleet = _make_fleet(run, calib, powers=(card_e["w"], idle_w), telemetry=rec,
                                   monitor=mon)
        billed = billed_fleet.run(run["workloads"]())
    mon.finalize()
    if _timeline(billed.fleet) != live_timeline:
        raise AssertionError(f"fleet {name}: the billed replay's timeline differs from the "
                             "live run's")
    if [(r.name, r.created_s, r.ready_s, r.stopped_s)
            for r in billed_fleet.replicas] != live_replicas:
        raise AssertionError(f"fleet {name}: the replay's replicas differ from the live run's")
    executed = sum(r.executed() for r in recorders)
    hits = sum(c.core.step_cache.hits for c in billed_fleet.replicas)
    if hits != executed:
        raise AssertionError(f"fleet {name}: {executed} dispatches executed, {hits} replayed")
    doc = to_perfetto(rec)
    problems = validate_trace(doc)
    if problems:
        raise AssertionError(f"fleet {name}: invalid trace: {problems[:5]}")

    m = billed.fleet.meter
    n_tok = live.fleet.total_tokens
    executed_s = sum(r.executed_s() for r in recorders)
    by_source = {src: {"active_j": d["active_j"], "idle_j": d["idle_j"], "lost_j": d["lost_j"],
                       "xfer_j": d["xfer_j"]} for src, d in sorted(m.by_source.items())}
    for unit in ("j", "g"):
        parts = sum(d[f"{b}_{unit}"] for d in m.by_source.values()
                    for b in ("active", "idle", "preempt", "xfer", "lost"))
        total = getattr(m, f"total_{unit}")
        if not math.isclose(parts, total, rel_tol=1e-9):
            raise AssertionError(f"fleet {name}: the fleet meter's {unit} {total} != its "
                                 f"replicas' {parts}")
    stats = billed.fleet.fleet
    # the merged meter holds joules; its seconds are at its own rates
    billed_s = sum(r.core.meter.active_s + r.core.meter.lost_s for r in billed_fleet.replicas)
    line = {
        "phase": "fleet_run", "run": name, "router": run["router"],
        "autoscaler": run["autoscaler"], "requests": len(live.fleet.responses),
        "tokens": n_tok, "virtual_makespan_s": max(r.done_s for r in live.fleet.responses),
        "endpoints": {
            ep: {"ttft_p50_s": em.ttft_percentile(50), "ttft_p95_s": em.ttft_percentile(95),
                 "latency_p50_s": em.latency_percentile(50),
                 "latency_p95_s": em.latency_percentile(95),
                 "tokens_per_s": em.throughput_tok_s, "requests": len(em.responses),
                 "tokens": em.total_tokens}
            for ep, em in live.endpoints.items()},
        "wall_s": card_e["s"], "energy_method": card.method, "card_j": card_e["j"],
        "card_mean_w": card_e["w"], "card_sampled_j": card_e["sampled_j"],
        "power_samples": card_e["samples"], "card_j_per_token": card_e["j"] / n_tok,
        "idle_w": idle_w,
        "meter_j_per_token": billed.fleet.energy_per_token_j,
        "meter_active_j_per_token": m.active_j / n_tok,
        "meter_j": m.total_j, "meter_active_j": m.active_j, "meter_idle_j": m.idle_j,
        "meter_lost_j": m.lost_j, "meter_xfer_j": m.xfer_j, "meter_preempt_j": m.preempt_j,
        "meter_g": m.total_g,
        "meter_work_over_card": (m.active_j + m.lost_j + m.preempt_j) / card_e["j"],
        "replicas": by_source, "replicas_created": stats["replicas_created"],
        "replica_seconds": stats["replica_seconds"], "peak_replicas": stats["peak_replicas"],
        "cold_starts": stats["cold_starts"], "scale_events": stats["scale_events"],
        "dispatches_executed": executed, "executed_s": executed_s,
        "billed_active_s": billed_s, "executed_over_billed": executed_s / billed_s,
        "prefills": launches["flash_attention"] // L + prefill_replays,
        "decode_steps": launches["decode_attention"] // L + replayed,
        "graph_replays": replayed, "launches": launches,
        "graph_replay_launches": graph_launches, "max_memory_allocated": peak,
        "si2_slot_captures": {"in_run": captured["count"] - slots0["count"],
                              "replicas_at_start": spawned, **captured},
        "trace_events": len(doc["traceEvents"]), "trace_valid": True,
        "monitor_windows": len(mon.windows), "alerts": len(mon.alerts),
        "incidents": [{k: i[k] for k in ("start", "end", "severity", "budgets", "endpoints",
                                          "alerts", "lost_j")} for i in mon.incidents],
        "alerts_by_budget": {b: sum(a["budget"] == b for a in mon.alerts)
                             for b in sorted({a["budget"] for a in mon.alerts})},
    }
    if handoffs:
        line.update(handoffs=handoffs, handoff_kv_bytes=handoff_bytes,
                    kv_cache_bytes_per_prompt=kv_cache_bytes(cfg, run["prompt_len"]))
    if run.get("crash"):
        line.update(workload_seed=run["workload_seed"], chaos_log=billed_fleet.chaos_log, availability=stats["availability"],
                    submitted_by_class=stats["submitted_by_class"],
                    delivered_by_class=stats["delivered_by_class"],
                    drops_by_class=stats["drops_by_class"], retries=stats["retries"])
        for c, n in stats["submitted_by_class"].items():
            if n != stats["delivered_by_class"].get(c, 0) + stats["drops_by_class"].get(c, 0):
                raise AssertionError(f"fleet {name}: class {c}: {n} submitted, not all "
                                     "delivered or dropped")
        if not m.lost_j > 0:
            raise AssertionError(f"fleet {name}: the crash lost no in-flight work")
    if not run.get("bills_both_legs"):
        # the meter bills what the card executed: its work joules sit just
        # below the counter's (the host's gaps between dispatches)
        if not 0.9 <= line["meter_work_over_card"] <= 1.0 + 1e-6:
            raise AssertionError(f"fleet {name}: meter work J / card J = "
                                 f"{line['meter_work_over_card']}")
    emit(line)
    return {"line": line, "tokens": tokens}


def _fleet_runs(seed: int, cfg, engines: dict, prompt_len: int, max_new: int) -> list:
    """The fleet phase's runs at full width: (name, fleet description)."""
    from repro_torch.serving.admission import DisaggRuntime, DisaggSpec
    from repro_torch.serving.scheduler import (DecodePhasePolicy, PrefillPhasePolicy,
                                               make_policy)
    from repro_torch.workload import poisson

    V = cfg.vocab_size

    def chat(s=seed):
        return poisson(32, prompt_len, max_new, V, rate_per_s=6.67, seed=s,
                       priority="interactive")

    # the chaos run's chat stream: the first seed from ``seed`` on that puts
    # two arrivals in the quarter second before the crash, so the crash
    # finds chat/r0 mid-dispatch and loses work (the lost bucket's path)
    crash_t = FLEET_CRASH[1]
    crash_seed = next(s for s in range(seed, seed + 100)
                      if sum(crash_t - 0.25 <= r.arrival_s < crash_t for r in chat(s)) >= 2)

    def bulk():
        return poisson(16, prompt_len, max_new, V, rate_per_s=3.33, seed=seed + 1, rid0=10**6)

    def dynamic():
        return make_policy("dynamic_batch", **FLEET_POLICY)

    def continuous():
        return make_policy("continuous_batch", **FLEET_POLICY)

    def endpoint(name, fmt, policy, n=None, **kw):
        fixed = {} if n is None else dict(min_replicas=n, max_replicas=n, initial_replicas=n)
        return dict(name=name, format=fmt, engine=engines[fmt], policy_factory=policy,
                    **fixed, **kw)

    routers = [dict(
        name=f"routers_{router}", router=router,
        autoscaler=dict(window_s=1.0, cold_start_s=0.5),
        endpoints=[endpoint("chat", "rsm", dynamic, ttft_slo_s=0.5, min_replicas=1,
                            max_replicas=4, initial_replicas=1),
                   endpoint("bulk", "rsm_int8", dynamic, min_replicas=1, max_replicas=4,
                            initial_replicas=1)],
        workloads=lambda: {"chat": chat(), "bulk": bulk()}) for router in ("round_robin",
                                                                          "greenest")]
    disagg = DisaggRuntime.from_spec(
        DisaggSpec(enabled=True, prefill_replicas=1, decode_replicas=1), cfg,
        prefill_policy_factory=lambda: PrefillPhasePolicy(FLEET_POLICY["max_batch"],
                                                          FLEET_POLICY["timeout_ms"]),
        decode_policy_factory=lambda: DecodePhasePolicy(FLEET_POLICY["max_batch"],
                                                        FLEET_POLICY["timeout_ms"]))
    return routers + [
        dict(name="disagg", router="least_loaded",
             autoscaler=dict(window_s=1.0, cold_start_s=0.5),
             endpoints=[endpoint("chat", "rsm", dynamic, ttft_slo_s=0.5, disagg=disagg)],
             workloads=lambda: {"chat": chat()}, bills_both_legs=True),
        # fixed pool, the autoscaler replaces the crashed replica
        dict(name="chaos", router="least_loaded",
             autoscaler=dict(window_s=0.25, cold_start_s=0.5),
             endpoints=[endpoint("chat", "rsm", dynamic, 2, ttft_slo_s=0.5)],
             workloads=lambda: {"chat": chat(crash_seed)}, crash=FLEET_CRASH,
             workload_seed=crash_seed),
        # F5's path at full width: two continuous pools of one SI2 engine
        dict(name="continuous", router="least_loaded",
             autoscaler=dict(window_s=1.0, cold_start_s=0.5),
             endpoints=[endpoint("chat", "rsm", continuous, 2, ttft_slo_s=0.5)],
             workloads=lambda: {"chat": chat()}),
    ]


def _fleet_smoke_f32(seed: int) -> dict:
    """minitron-4b-smoke in f32 on one SI2 engine: a two-replica
    continuous-batching fleet (fixed pool, least_loaded) with every
    dispatch executed gives every request the tokens one SI1 core gives
    it; and so does the same fleet beside a dynamic-batching endpoint on
    the same engine (``generate`` next to live slot pools)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.engines import CompiledEngine, EagerEngine
    from repro_torch.models import transformer
    from repro_torch.serving.fleet import EndpointSpec, ReplicaFleet
    from repro_torch.serving.scheduler import make_policy
    from repro_torch.workload import poisson

    cfg = get_arch("minitron-4b-smoke")
    params = transformer.init_params(cfg, seed, device="cuda")
    V = cfg.vocab_size

    def chat():
        return poisson(24, 8, 6, V, rate_per_s=300.0, seed=seed)

    def bulk():
        return poisson(12, 8, 6, V, rate_per_s=150.0, seed=seed + 1, rid0=1000)

    want = _cb_tokens(EagerEngine(cfg, params, 64), chat() + bulk(), 4, 64)
    si2 = CompiledEngine(cfg, params, 64)
    out = {"arch": cfg.name, "dtype": cfg.dtype}
    for case, workloads in (("continuous", {"chat": chat()}),
                            ("continuous_and_dynamic", {"chat": chat(), "bulk": bulk()})):
        fleet = ReplicaFleet(router="least_loaded")
        fleet.add_endpoint(EndpointSpec(
            name="chat", engine=si2, use_step_cache=False, min_replicas=2, max_replicas=2,
            initial_replicas=2,
            policy_factory=lambda: make_policy("continuous_batch", max_batch=4, max_seq=64)))
        if "bulk" in workloads:
            fleet.add_endpoint(EndpointSpec(
                name="bulk", engine=si2, use_step_cache=False, min_replicas=1,
                max_replicas=1, initial_replicas=1,
                policy_factory=lambda: make_policy("dynamic_batch", max_batch=4,
                                                   timeout_ms=10.0)))
        res = fleet.run(workloads)
        got = {r.rid: [int(t) for t in r.tokens] for r in res.fleet.responses}
        pools = [r.core.policy.kv for r in fleet.replicas if r.endpoint == "chat"]
        # simlint: allow(id-key) -- this process's graphs, keyed within one run
        graphs = {id(si2.graph_of(kv)) for kv in pools}
        offered = {r.name: r.offered for r in fleet.replicas}
        differ = [rid for rid in got if got[rid] != want[rid]]
        if differ or len(got) != sum(len(w) for w in workloads.values()):
            raise AssertionError(f"fleet f32 smoke {case}: tokens differ from one SI1 core's "
                                 f"for requests {differ}")
        if len(graphs) != 2 or 0 in offered.values():
            raise AssertionError(f"fleet f32 smoke {case}: the two pools share a graph or a "
                                 f"replica got no work ({offered})")
        out[case] = {"requests": len(got), "tokens_equal_si1": True, "offered": offered}
        del fleet, res, pools
    out["si2_slot_captures"] = _slot_captures([si2])
    return out


def phase_fleet(seed: int, prompt_len: int = 512, max_new: int = 32) -> dict:
    """The replica fleet at full width on the card, with its own energy."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.engines import CompiledEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params
    from repro_torch.serving.stepcache import StepTimeCache, calibrate

    t_phase = time.perf_counter()
    gc.collect()                  # the earlier phases' engines, cycles included
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    # what stays allocated then is cuBLAS's workspace of each pool stream a
    # capture or a timed graph used; PyTorch keeps one per stream
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    out = {"phase": "fleet", "memory_allocated_at_start": held,
           "memory_allocated_without_cublas_workspaces":
               torch.cuda.memory_allocated() if clear is not None else None,
           "smoke_f32": _fleet_smoke_f32(seed)}
    cfg = get_arch("minitron-4b")
    max_seq = FLEET_POLICY["max_seq"]
    card = CardEnergy()
    params = transformer.init_params(cfg, seed, device="cuda")
    engines = {"rsm": CompiledEngine(cfg, params, max_seq),
               "rsm_int8": CompiledEngine(cfg, quantize_params(params), max_seq)}
    # calibration, graph captures and first calls stay outside every
    # energy window: generate at B = 1..8 and the 8-slot pool's primitives
    t0 = time.perf_counter()
    calib = {fmt: calibrate(eng, StepTimeCache(), batch_sizes=range(1, 9),
                            prompt_len=prompt_len, max_new=max_new, vocab=cfg.vocab_size,
                            num_slots=FLEET_POLICY["max_batch"], max_seq=max_seq)
             for fmt, eng in engines.items()}
    torch.cuda.synchronize()
    out.update(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, dtype=cfg.dtype,
               max_seq=max_seq, prompt_len=prompt_len, max_new=max_new,
               policy_args=FLEET_POLICY, warmup_s=time.perf_counter() - t0,
               calibration={fmt: {" ".join(map(str, k)): v for k, v in c.to_payload().items()}
                            for fmt, c in calib.items()},
               energy_method=card.method, gpu=smi())
    _, idle = card.measure(lambda: time.sleep(2.0))
    out["idle"] = idle
    # the phase's launches are its runs' own: each run counts from 0 just
    # before its fleet.run and reads the counts just after
    runs = []
    launches = dict.fromkeys(ops.launch_counts(), 0)
    graph_launches = dict(launches)
    for run in _fleet_runs(seed, cfg, engines, prompt_len, max_new):
        run["prompt_len"] = prompt_len
        done = _fleet_run(card, run, calib, idle["w"], list(engines.values()))
        line = done["line"]
        for k in launches:
            launches[k] += line["launches"][k]
            graph_launches[k] += line["graph_replay_launches"][k]
        runs.append({k: line[k] for k in (
            "run", "router", "tokens", "card_mean_w", "card_j_per_token", "meter_j_per_token",
            "meter_active_j_per_token", "meter_work_over_card", "replica_seconds",
            "cold_starts", "executed_over_billed", "decode_steps", "graph_replays")})
    for k in ("flash_attention", "decode_attention", "int8_matmul"):
        if launches[k] + graph_launches[k] == 0:
            raise AssertionError(f"fleet phase: {k} was never launched in a run "
                                 f"({launches}, replays {graph_launches})")
    card.close()
    out.update(runs=runs, launches=launches, graph_replay_launches=graph_launches,
               si2_slot_captures=_slot_captures(engines.values()),
               seconds=time.perf_counter() - t_phase)
    del engines, params, calib
    torch.cuda.empty_cache()
    emit(out)
    return out


# -- the api phase: the declarative spec API -------------------------------------------

API_SMOKE_ARCHS = ("minitron-4b-smoke", "mixtral-8x7b-smoke", "rwkv6-3b-smoke",
                   "zamba2-2.7b-smoke", "whisper-small-smoke")
API_POLICY = dict(max_batch=8, batch_timeout_ms=20.0, max_seq=1024)


def _api_endpoint(name: str, arch: str, fmt: str, si: str, **kw):
    """A one-replica endpoint (no autoscaling) of dynamic batching whose
    every dispatch executes (no step cache)."""
    from repro_torch.serving.api import AutoscaleSpec, EndpointSpec

    return EndpointSpec(name=name, arch=arch, model=arch, format=fmt, si=si, step_cache=False,
                        autoscale=AutoscaleSpec(enabled=False, max_replicas=1), **kw)


def _session_run(session, names) -> tuple:
    """``session.run()`` with the launch counters set to 0 just before it and
    read just after; returns (report, eager launches, launches the engines'
    graph replays made, {name: {batch: replays}})."""
    from repro_torch.kernels import ops

    engines = {n: session.engine(n) for n in names}
    replays0 = {n: _graph_replays(e) for n, e in engines.items()}
    ops.reset_launch_counts()
    report = session.run()
    launches = ops.launch_counts()
    graph_launches = dict.fromkeys(launches, 0)
    by_batch = {}
    for n, e in engines.items():
        replayed, gl, _ = _replayed_since(e, replays0[n], launches)
        for k, v in gl.items():
            graph_launches[k] += v
        # simlint: allow(id-key) -- this process's graphs, keyed within one run
        by_batch[n] = {g.batch: replayed[id(g)] for g in _engine_graphs(e) if replayed[id(g)]}
    return report, launches, graph_launches, by_batch


def _report_tokens(report) -> dict:
    return {name: {r.rid: [int(t) for t in r.tokens] for r in ep.metrics.responses}
            for name, ep in report.endpoints.items()}


def _api_smoke_f32(seed: int) -> dict:
    """minitron-4b-smoke (rsm), mixtral-8x7b-smoke, rwkv6-3b-smoke,
    zamba2-2.7b-smoke and whisper-small-smoke in f32 through
    ServingSession, each a burst of 8 requests at t = 0 (8-token
    prompts, 6 new tokens), first on SI1, then the same spec on SI2 through
    ``with_override`` plus minitron-4b-smoke from rsm_int8 (the spec API
    rejects rsm_int8 on SI1; its SI2 tokens are held against an eager engine
    on the weights the session loaded).  SI2's tokens must equal SI1's, and
    K1-K5 must each launch inside the SI2 session's ``run()``."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.engines import EagerEngine
    from repro_torch.models import transformer
    from repro_torch.serving.api import ServingSession, ServingSpec, with_override
    from repro_torch.serving.request import Request

    policy = dict(API_POLICY, max_seq=64)
    params = {a: transformer.init_params(get_arch(a), seed, device="cuda")
              for a in API_SMOKE_ARCHS}
    spec_si1 = ServingSpec(endpoints=tuple(
        _api_endpoint(a.split("-")[0], a, "rsm", "si1_no_runtime", **policy)
        for a in API_SMOKE_ARCHS)).validate()
    spec_si2 = with_override(spec_si1, "endpoints.*.si", "si2_runtime")
    int8 = dataclasses.replace(spec_si2.endpoints[0], name="minitron_int8", format="rsm_int8")
    spec_si2 = dataclasses.replace(spec_si2, endpoints=spec_si2.endpoints + (int8,)).validate()
    rng = np.random.default_rng(seed)
    prompts = {ep.name: rng.integers(0, get_arch(ep.arch).vocab_size, (8, 8)).astype(np.int32)
               for ep in spec_si2.endpoints}
    out = {"archs": list(API_SMOKE_ARCHS), "dtype": "float32", "requests_per_endpoint": 8}
    tokens, sessions = {}, {}
    for si, spec in (("SI1", spec_si1), ("SI2", spec_si2)):
        session = ServingSession().deploy(spec, params=params)
        for i, ep in enumerate(spec.endpoints):
            # SI2 captures its graph of a batch of 8 here, outside run()
            session.engine(ep.name).warmup(8, 8)
            session.submit(ep.name, [Request(rid=100 * i + j, prompt=p, max_new_tokens=6)
                                     for j, p in enumerate(prompts[ep.name])])
        report, launches, graph_launches, by_batch = _session_run(
            session, [ep.name for ep in spec.endpoints])
        tokens[si] = _report_tokens(report)
        sessions[si] = session
        for name, got in tokens[si].items():
            if len(got) != 8:
                raise AssertionError(f"api f32 smoke {si}: {name} answered {len(got)} of 8")
        out[si] = {"launches": launches, "graph_replay_launches": graph_launches,
                   "graph_replays_by_batch": by_batch,
                   "engines": {ep.name: session.engine(ep.name).name for ep in spec.endpoints}}
    for name, want in tokens["SI1"].items():
        if tokens["SI2"][name] != want:
            raise AssertionError(f"api f32 smoke: {name}'s SI2 tokens differ from SI1's")
    engine = sessions["SI2"].engine("minitron_int8")
    eager = EagerEngine(engine.cfg, engine.params, engine.max_seq).generate(
        prompts["minitron_int8"], 6).tokens
    rid0 = 100 * (len(spec_si2.endpoints) - 1)
    if tokens["SI2"]["minitron_int8"] != {rid0 + j: eager[j].tolist() for j in range(8)}:
        raise AssertionError("api f32 smoke: minitron_int8's SI2 tokens differ from eager")
    total = {k: out["SI2"]["launches"][k] + out["SI2"]["graph_replay_launches"][k]
             for k in SERVE_KERNELS}
    if not all(total.values()):
        raise AssertionError(f"api f32 smoke: a kernel never launched in run() ({total})")
    out.update(tokens_si2_equal_si1=True, int8_tokens_equal_eager=True)
    return out


def _registry_bytes(params, fmt: str) -> int:
    """Bytes ``save_rsm`` writes for ``params`` in ``fmt``: bf16 leaves as
    f32, the quantizable ones in rsm_int8 as int8 plus f32 scales."""
    from repro_torch.serving import formats

    total = 0
    for key, t in formats._flatten(params).items():
        if fmt == "rsm_int8" and formats._quantizable(key, t):
            total += t.numel() + 4 * t.numel() // t.shape[-2]
        else:
            total += 4 * t.numel()
    return total


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


@contextlib.contextmanager
def _registered(cfg):
    """``cfg`` resolvable by name (``get_arch``) while open: a depth cut of a
    registered arch, which the spec API looks up by its ``arch`` field."""
    from repro_torch.configs import ARCHS

    known = cfg.name in ARCHS
    ARCHS.setdefault(cfg.name, cfg)
    try:
        yield cfg
    finally:
        if not known:
            del ARCHS[cfg.name]


def _api_depth(seed: int, disk_free: int, fmts=("rsm", "rsm_int8")) -> tuple:
    """(minitron-4b at full width, its weights on the card, the registry's
    bytes, why depth was cut or None): all 32 layers unless the temp disk
    cannot hold the files of ``fmts`` (with 10 % to spare); then as many
    layers as it can, width kept."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer

    cfg = get_arch("minitron-4b")
    params = transformer.init_params(cfg, seed, device="cuda")
    need = sum(_registry_bytes(params, f) for f in fmts)
    if need * 1.1 <= disk_free:
        return cfg, params, need, None
    per_layer = sum(_registry_bytes({"layers": params["layers"]}, f)
                    for f in fmts) / cfg.num_layers
    fixed = need - per_layer * cfg.num_layers
    n = int((disk_free / 1.1 - fixed) // per_layer)
    if n < 1:
        raise AssertionError(f"{disk_free} B of temp disk hold no layer of "
                             f"{cfg.name} ({need} B for all {cfg.num_layers})")
    cut = dataclasses.replace(cfg, name=f"{cfg.name}-{n}l", num_layers=n)
    del params
    params = transformer.init_params(cut, seed, device="cuda")
    reason = (f"{n} of {cfg.num_layers} layers: the registry needs {need} B for all, the "
              f"temp disk has {disk_free} B free")
    return cut, params, sum(_registry_bytes(params, f) for f in fmts), reason


def _derived_entry(engine, batch: float, context: float, chip) -> dict:
    """The roofline's J/token of one SI2 decode step of ``engine`` at mean
    batch ``batch`` and mean context ``context``: FLOPs 2 x (parameters a
    step multiplies) x B, bytes the weights a step reads plus the KV read."""
    from repro_torch.energy.estimator import RooflineTerms, energy_per_token_j, step_power_w
    from repro_torch.serving.formats import QTensor

    def leaves(tree, key=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{key}/{k}") if isinstance(v, dict) else [(f"{key}/{k}", v)])

    n_params = weight_bytes = 0
    for key, leaf in leaves(engine.params):
        if key == "/embed":
            continue                  # a step gathers B rows of it
        t = leaf.wq if isinstance(leaf, QTensor) else leaf
        n_params += t.numel()
        weight_bytes += t.numel() * t.element_size()
        if isinstance(leaf, QTensor):
            weight_bytes += leaf.scales.numel() * leaf.scales.element_size()
    cfg = engine.cfg
    kv_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2 * context * batch
    terms = RooflineTerms(flops=2.0 * n_params * batch, hbm_bytes=weight_bytes + kv_bytes,
                          collective_bytes=0.0, chips=1, chip=chip)
    return {"chip": chip.name, "batch": batch, "context": context, "flops": terms.flops,
            "hbm_bytes": terms.hbm_bytes, "t_step_s": terms.t_step,
            "bottleneck": terms.bottleneck, "power_w": step_power_w(terms),
            "j_per_token": energy_per_token_j(terms, 1) / batch}


def _api_full_width(seed: int, card, prompt_len: int = 512, max_new: int = 32) -> dict:
    """Full-width minitron-4b (bf16, max_seq 1024) through one ServingSpec:
    chat (rsm, interactive, 16 Poisson requests at 6.67 req/s) and bulk
    (rsm_int8, 8 at 3.33 req/s) behind round_robin, one SI2 replica each on
    dynamic batching, served by ``run_declared``.  The spec's power envelope
    is the card's: idle from a 2-s NVML reading, active the mean draw over
    ``calibrate`` at B = 1..8, both outside the run.  The run is read by the
    card's energy counter beside the report's metered joules."""
    import gc
    import shutil

    import torch

    from repro_torch.core.add import (Deployment, ModelFormat, RequestProcessing,
                                      ServingInfrastructure)
    from repro_torch.energy.hw import H100_SXM
    from repro_torch.energy.report import build_green_report
    from repro_torch.serving.api import ServingSession, ServingSpec, SLOClass, with_override
    from repro_torch.workload import WorkloadSpec

    disk_free = shutil.disk_usage(tempfile.gettempdir()).free
    cfg, params, need, depth_cut = _api_depth(seed, disk_free)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "depth_cut": depth_cut, "temp_disk_free": disk_free,
           "registry_bytes_expected": need, "prompt_len": prompt_len, "max_new": max_new,
           "policy": API_POLICY, "router": "round_robin"}
    wl = dict(kind="poisson", prompt_len=prompt_len, max_new_tokens=max_new)
    with _registered(cfg):
        spec = ServingSpec(endpoints=(
            _api_endpoint("chat", cfg.name, "rsm", "si2_runtime", ttft_slo_ms=500.0,
                          slo_classes={"interactive": SLOClass(slo_ms=500.0,
                                                               priority="interactive")},
                          workload=WorkloadSpec(n=16, rate_per_s=6.67, seed=seed, slo_ms=500.0,
                                                priority="interactive", **wl), **API_POLICY),
            _api_endpoint("bulk", cfg.name, "rsm_int8", "si2_runtime",
                          workload=WorkloadSpec(n=8, rate_per_s=3.33, seed=seed + 1, rid0=10**6,
                                                **wl), **API_POLICY),
        ), router="round_robin").validate()
        session = ServingSession()
        t0 = time.perf_counter()
        session.deploy(spec, params={cfg.name: params})
        torch.cuda.synchronize()
        out["deploy_s"] = time.perf_counter() - t0
        out["registry_bytes"] = _dir_bytes(session._registry())
        _, idle = card.measure(lambda: time.sleep(2.0))
        # calibration captures each engine's graphs of B = 1..8: the run
        # itself captures nothing (dynamic batching decodes generate's graphs)
        _, cal = card.measure(lambda: [session.calibrate(
            n, batch_sizes=range(1, API_POLICY["max_batch"] + 1), prompt_len=prompt_len,
            max_new=max_new) for n in ("chat", "bulk")])
        spec = with_override(with_override(spec, "active_power_w", cal["w"]),
                             "idle_power_w", idle["w"])
        session.deploy(spec, params={cfg.name: params})
        for ep in spec.endpoints:
            session.submit(ep.name, session.declared_workloads()[ep.name])
        engines = [session.engine(n) for n in ("chat", "bulk")]
        graphs0 = sum(len(_engine_graphs(e)) for e in engines)
        torch.cuda.reset_peak_memory_stats()
        (report, launches, graph_launches, by_batch), card_e = card.measure(
            lambda: _session_run(session, ("chat", "bulk")))
        peak = torch.cuda.max_memory_allocated()
        # run() adds the endpoints to its fleet inside the energy window; on
        # dynamic batching that captures no graph (calibrate did, outside)
        captured = sum(len(_engine_graphs(e)) for e in engines) - graphs0
        if captured:
            raise AssertionError(f"api run: {captured} graphs captured inside the run")
        # one replica an endpoint: a dispatch is the batch of responses that
        # started together, and each runs one eager prefill
        dispatches = {n: len({r.start_s for r in ep.metrics.responses})
                      for n, ep in report.endpoints.items()}
        per_prefill = _launches_per_pass(cfg, session.engine("bulk").params)[0]
        want = {"flash_attention": cfg.num_layers * sum(dispatches.values()),
                "int8_matmul": per_prefill["int8_matmul"] * dispatches["bulk"]}
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"api run: {k} launched {launches[k]} times, {n} expected "
                                     f"from the dispatches {dispatches}")
        for k in ("flash_attention", "decode_attention", "int8_matmul"):
            if launches[k] + graph_launches[k] == 0:
                raise AssertionError(f"api run: {k} was never launched ({launches}, "
                                     f"replays {graph_launches})")
        n_req = {n: len(ep.metrics.responses) for n, ep in report.endpoints.items()}
        if n_req != {"chat": 16, "bulk": 8}:
            raise AssertionError(f"api run: answered {n_req} of chat 16, bulk 8")
        fleet = report.fleet
        n_tok = fleet.total_tokens
        endpoints = {}
        for n, ep in report.endpoints.items():
            m = ep.metrics
            batch = n_req[n] / dispatches[n]
            derived = _derived_entry(session.engine(n), batch, prompt_len + max_new / 2,
                                     H100_SXM)
            endpoints[n] = {
                "format": ep.decisions["format"], "requests": n_req[n], "tokens": m.total_tokens,
                "ttft_p50_s": m.ttft_percentile(50), "ttft_p95_s": m.ttft_percentile(95),
                "latency_p50_s": m.latency_percentile(50),
                "latency_p95_s": m.latency_percentile(95), "tokens_per_s": m.throughput_tok_s,
                "dispatches": dispatches[n], "mean_batch": batch,
                "graph_replays_by_batch": by_batch[n], "j_per_token": ep.j_per_token,
                "j_active": ep.j_active, "j_idle": ep.j_idle,
                "j_container_overhead": ep.j_container_overhead, "derived": derived}
            dep = Deployment(arch=cfg.name, si=ServingInfrastructure.SI2_RUNTIME_ENGINE,
                             model_format=ModelFormat(ep.decisions["format"]),
                             request_processing=RequestProcessing.DYNAMIC_BATCH,
                             max_batch=API_POLICY["max_batch"], max_seq=API_POLICY["max_seq"])
            print(f"[green report {n}]\n" + build_green_report(dep, m).table(), file=sys.stderr)
            print(f"[derived {n}] " + json.dumps(derived), file=sys.stderr, flush=True)
        line = {
            "phase": "api_run", **out, "endpoints": endpoints, "requests": fleet.n_requests,
            "tokens": n_tok, "virtual_makespan_s": max(r.done_s for r in fleet.metrics.responses),
            "wall_s": card_e["s"], "energy_method": card.method, "card_j": card_e["j"],
            "card_mean_w": card_e["w"], "card_sampled_j": card_e["sampled_j"],
            "card_j_per_token": card_e["j"] / n_tok, "idle_w": idle["w"], "idle": idle,
            "calibrate": cal, "spec_active_power_w": spec.active_power_w,
            "spec_idle_power_w": spec.idle_power_w, "j_per_token": fleet.j_per_token,
            "j_active": fleet.j_active, "j_idle": fleet.j_idle,
            "j_container_overhead": fleet.j_container_overhead,
            "meter_active_over_card": fleet.j_active / card_e["j"],
            "replica_seconds": fleet.replica_seconds,
            "launches": launches, "graph_replay_launches": graph_launches,
            "graphs_captured_in_run": captured, "max_memory_allocated": peak, "gpu": smi(),
        }
        emit(line)
        del session, report, params, engines
        gc.collect()
        torch.cuda.empty_cache()
    return line


def _api_cli(seed: int) -> dict:
    """``python -m repro_torch.launch.serve`` at full width on the card: it
    must exit 0 and print its spec JSON, summary and green report."""
    import shutil

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = ["--arch", "minitron-4b", "--format", "rsm_int8", "--si", "si2_runtime",
            "--requests", "8", "--seed", str(seed)]
    disk_free = shutil.disk_usage(tempfile.gettempdir()).free
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    seconds = time.perf_counter() - t0
    print(f"[cli] python -m repro_torch.launch.serve {' '.join(argv)}\n{done.stdout}"
          f"{done.stderr[-4000:]}", file=sys.stderr, flush=True)
    lines = done.stdout.splitlines()
    if done.returncode != 0:
        raise AssertionError(f"api cli exited {done.returncode}: {done.stderr[-2000:]}")
    start = lines.index("{")
    spec = json.loads("\n".join(lines[start:lines.index("}", start) + 1]))
    summary = next(ln for ln in lines if ln.startswith("{'n_requests'"))
    if "'n_requests': 8" not in summary or not any(
            ln.startswith("# quality report:") for ln in lines):
        raise AssertionError(f"api cli: no summary of 8 requests or no green report: {summary}")
    return {"argv": argv, "rc": done.returncode, "seconds": seconds,
            "temp_disk_free": disk_free, "spec_format": spec["endpoints"][0]["format"],
            "summary": summary, "decision_line": lines[0]}


def phase_api(seed: int) -> dict:
    """The declarative spec API on the card (see the module docstring)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "api", "smoke_f32": _api_smoke_f32(seed)}
    gc.collect()
    torch.cuda.empty_cache()
    card = CardEnergy()
    try:
        run = _api_full_width(seed, card)
    finally:
        card.close()
    out["cli"] = _api_cli(seed)
    # the phase's launches are its sessions' run() windows: the f32 smoke's
    # SI1 and SI2 runs and the full-width run
    out["launches"] = {k: out["smoke_f32"]["SI1"]["launches"][k]
                       + out["smoke_f32"]["SI2"]["launches"][k] + run["launches"][k]
                       for k in KERNEL_SOURCES}
    out["graph_replay_launches"] = {
        k: out["smoke_f32"]["SI2"]["graph_replay_launches"][k]
        + run["graph_replay_launches"][k] for k in KERNEL_SOURCES}
    out["run"] = {k: run[k] for k in ("layers", "depth_cut", "card_j_per_token", "j_per_token",
                                      "deploy_s", "registry_bytes", "tokens")}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# -- the train phase ------------------------------------------------------------------

# K1 with lse and K1's backward at the training shapes: (B, H, K, Sq, T, dh,
# causal, window, what)
TRAIN_ATTN_CASES = (
    (2, 24, 8, 512, 512, 128, True, None, "minitron-4b"),
    (2, 32, 32, 512, 512, 80, True, 4096, "zamba2-2.7b shared block"),
    (2, 12, 12, 1500, 1500, 64, True, None, "whisper-small encoder"),
    (2, 12, 12, 64, 1500, 64, False, None, "whisper-small cross attention"))
# one smoke arch of each family (three of dense/vlm, arctic's dense residual
# beside mixtral): trained card against CPU
TRAIN_SMOKE_ARCHS = ("minitron-4b-smoke", "qwen3-8b-smoke", "qwen2-vl-2b-smoke",
                     "zamba2-2.7b-smoke", "whisper-small-smoke", "mixtral-8x7b-smoke",
                     "arctic-480b-smoke", "rwkv6-3b-smoke")
# the full-width train runs: (arch, layers trained or None for all, steps)
TRAIN_FULL_WIDTH = (
    ("minitron-4b", None, 5),
    # 32 layers, 3.06 B parameters: ~46 GB at PR 20's 14.9 bytes a trained one
    ("rwkv6-3b", None, 3),
    # 3 of 32 layers, 4.62 B parameters: ~69 GB; 4 layers (6.07 B) would not fit
    ("mixtral-8x7b", 3, 3),
)
TRAIN_LOSS_ATOL, TRAIN_GRAD_ATOL = 1e-4, 1e-3
TRAIN_UPDATE_ATOL = 1e-6   # an f32 parameter after one step; the step moves it ~lr (3e-4)
# torch.profiler's kernels of a train step by part (kernel-name fragments)
# (by the port's kernel prefixes first, so that no "gemm" fragment takes K4's)
TRAIN_PARTS = (("k1_fwd", ("namespace)::flash_",)), ("k1_bwd", ("namespace)::attn_bwd_",)),
               ("k4_fwd", ("namespace)::gmm_",)), ("k4_bwd", ("namespace)::gmmbwd_",)),
               ("k5_fwd", ("namespace)::wkv_",)), ("k5_bwd", ("namespace)::wkvbwd_",)),
               ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
               ("loss", ("softmax", "SoftMax", "gather", "nll")))


def _train_attention_cases(seed: int) -> tuple:
    """K1 with lse and K1's backward against their plain versions at the
    training shapes, bf16 (timed) and f32, with each backward case's planned
    path and dq splits; SDPA's forward, and SDPA's backward alone on one
    retained forward, are the library yardsticks (SDPA's forward + backward
    is timed beside them, the reading earlier rows were held against)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k1
    from repro_torch.kernels import flash_attention_bwd as k1b
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 20)
    fwd_cases, bwd_cases = [], []
    for (B, H, K, S, T, dh, causal, window, what) in TRAIN_ATTN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
            q, k, v = (mk(B, S, H, dh).transpose(1, 2), mk(B, T, K, dh).transpose(1, 2),
                       mk(B, T, K, dh).transpose(1, 2))
            do = mk(B, S, H, dh).transpose(1, 2)
            kw = dict(causal=causal, window=window)
            tag = f"{what} {dtype}"
            o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
            want_o, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            err = max(check_close(f"flash_attention {tag} out", o, want_o, *_tol(dtype)),
                      check_close(f"flash_attention {tag} lse", lse, want_lse, *_tol(dtype)))
            got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            berr = max(check_grad(f"flash_attention_bwd {tag} {n}", a, b, *_tol(dtype))
                       for n, a, b in zip(("dq", "dk", "dv"), got, want))
            again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {tag}: two calls differ")
            base = {"shape": [B, H, K, S, dh], "window": window, "dtype": str(dtype)[6:],
                    "arch": what}
            if (T, causal) != (S, True):
                base.update(kv_len=T, causal=causal)
            fwd = dict(base, path=k1.plan_call(q, k, v), lse=True, max_abs_err=err)
            path = k1b.plan_call(q, k, v, o, do)
            splits = (k1b.dq_plan(B, H, S, T, build.sm_count(0)).splits if path == "mma"
                      else 1)
            bwd = dict(base, path=path, dq_splits=splits, max_abs_err=berr, bit_identical=True)
            if dtype == torch.bfloat16:
                es = q.element_size()
                pairs = B * H * (S * (S + 1) / 2 if causal else S * T)   # live (q, k) pairs
                io = (2 * B * S * H * dh + 2 * B * T * K * dh) * es + 4 * B * H * S
                timed(fwd, lambda: ops.flash_attention(q, k, v, return_lse=True, **kw),
                      lambda: ref.flash_attention_ref(q, k, v, return_lse=True, **kw),
                      lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=True),
                      io, 4 * dh * pairs)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

                def sdpa_fwd_bwd():
                    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                         enable_gqa=True)
                    return torch.autograd.grad(out, (ql, kl, vl), do)

                retained = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                          enable_gqa=True)

                def sdpa_bwd():   # the function the kernel computes: the backward alone
                    return torch.autograd.grad(retained, (ql, kl, vl), do, retain_graph=True)

                # reads q, k, v, o, do, lse; writes dq, dk, dv; 5 products
                nbytes = (3 * B * S * H * dh + 2 * B * T * K * dh) * es + 4 * B * H * S \
                    + (B * S * H * dh + 2 * B * T * K * dh) * es
                kernel = lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
                timed(bwd, kernel, lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
                      sdpa_bwd, nbytes, 5 * 2 * dh * pairs, graph_library=False)
                bwd["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
                # SDPA's autograd calls are not captured in a graph: their
                # device time, and the kernel's, from torch.profiler instead
                for name, fn in (("kernel", kernel), ("library", sdpa_bwd),
                                 ("library_fwd_bwd", sdpa_fwd_bwd)):
                    us = device_us({name: fn})
                    bwd[f"{name}_device_ms"] = sum(us.values()) / 1e3
                    bwd[f"{name}_device_us"] = us
                    bwd[f"{name}_device_ms_clean"] = sum(
                        device_us({name: fn}, clean=True).values()) / 1e3
                bwd["device_factor"] = bwd["kernel_device_ms"] / bwd["library_device_ms"]
            emit_case("flash_attention", fwd)
            emit_case("flash_attention_bwd", bwd)
            fwd_cases.append(fwd)
            bwd_cases.append(bwd)
    return fwd_cases, bwd_cases


def _moe_gmm_bwd_cases(seed: int) -> list:
    """K4's backward against its plain version: mixtral-8x7b's training gate/up
    and down (B 2 x S 512, top-2: C 320, 2048 routed rows) with the group
    sizes a uniform router gives and with empty experts, bf16 (timed: both
    gradients, then dx and dw alone, each beside torch.bmm over every expert)
    and f32; and a C <= 32 shape (one short tile of C for both gradients).
    bf16 runs dx and dw on wgmma, dx on its stream-K schedule (each case
    records it: blocks, units, tiles cut across blocks, workspace).  Two
    calls must give the same bits, and so must a CUDA-graph replay of dx,
    also after new group sizes are copied in (dx reads them on the device);
    rows at or past group_sizes[e] must be exact zeros.
    Bound, each gradient alone by what it needs: dx the weights of experts
    with live rows and the live rows of dy read once, dx written once; dw
    the live rows of x and dy read once, dw written once; both together the
    union."""
    import numpy as np
    import torch

    from repro_torch.kernels import moe_gmm_bwd as k4b
    from repro_torch.kernels import ops, ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def schedule(E, C, D, F, gs_np):
        """dx's stream-K schedule for these group sizes (the kernel finds the
        same from group_sizes on the device)."""
        tiles = int(sum(-(-min(int(g), C) // k4b.DX_BM) for g in gs_np)) * -(-D // k4b.DX_BN)
        ktiles, grid = -(-F // k4b.DX_BK), k4b.dx_grid(E, C, D, F, sms)
        units = k4b.dx_units(tiles, ktiles, grid)
        s = k4b.dx_schedule(tiles, ktiles, grid)
        return {"grid": grid, "tiles": tiles, "k_steps": ktiles, "full_rounds": s.rounds,
                "tiles_cut": s.left if s.pieces > 1 else 0, "pieces": s.pieces,
                "units": sum(map(len, units)),
                "max_k_steps_a_block": max(sum(u.k1 - u.k0 for u in b) for b in units),
                "workspace_bytes": k4b.workspace_bytes(grid)}

    def graph_dx(x, w, gs, dy, dx, other_gs):
        """dx replayed from a CUDA graph equals the eager dx bit for bit, and
        after other group sizes are copied in, the eager dx of those."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            replayed, _ = ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)
        g.replay()
        torch.cuda.synchronize()
        ok = torch.equal(replayed, dx)
        saved = gs.clone()
        gs.copy_(torch.as_tensor(other_gs, dtype=torch.int32))
        g.replay()
        ok = ok and torch.equal(replayed, ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)[0])
        gs.copy_(saved)
        if not ok:
            raise AssertionError("moe_gmm_bwd: dx replayed from a graph differs from eager")

    rng = np.random.default_rng(seed + 22)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 22)
    uniform = np.minimum(rng.multinomial(2048, [1 / 8] * 8), 320)
    empty = rng.integers(0, 321, 8)
    empty[[0, 3]] = 0
    empty[5] = 320
    small = np.array([24, 0, 7, 13, 0, 24, 1, 19, 0, 3, 24, 24, 0, 0, 11, 2])
    shapes = [  # (E, C, D, F, group sizes, dtypes, timed)
        (8, 320, 4096, 14336, uniform, (torch.bfloat16, torch.float32), True),    # gate / up
        (8, 320, 14336, 4096, uniform, (torch.bfloat16, torch.float32), True),    # down
        (8, 320, 4096, 14336, empty, (torch.bfloat16,), False),
        (8, 320, 14336, 4096, empty, (torch.bfloat16,), False),
        (16, 24, 1024, 512, small, (torch.bfloat16, torch.float32), False),      # C <= 32
    ]
    cases = []
    for (E, C, D, F, gs_np, dtypes, is_timed) in shapes:
        gs = torch.tensor(gs_np, dtype=torch.int32, device="cuda")
        for dtype in dtypes:
            x = torch.randn(E, C, D, generator=g, device="cuda").to(dtype)
            w = (torch.randn(E, D, F, generator=g, device="cuda") * D ** -0.5).to(dtype)
            dy = torch.randn(E, C, F, generator=g, device="cuda").to(dtype)
            got = ops.moe_gmm_bwd(x, w, gs, dy)
            want = ref.moe_gmm_bwd_ref(x, w, gs, dy)
            tag = f"moe_gmm_bwd {E, C, D, F} {dtype}"
            err = max(check_grad(f"{tag} {n}", a, b, *_tol(dtype))
                      for n, a, b in zip(("dx", "dw"), got, want))
            again = ops.moe_gmm_bwd(x, w, gs, dy)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: two calls differ")
            for e, size in enumerate(gs_np.tolist()):
                if torch.count_nonzero(got[0][e, size:]):
                    raise AssertionError(f"{tag}: dx rows at or past {size} of expert {e}")
            p = k4b.plan_call(x, w, dy)
            case = {"shape": [E, C, D, F], "group_sizes": gs_np.tolist(),
                    "dtype": str(dtype)[6:], "path": {"dx": p.dx, "dw": p.dw},
                    "max_abs_err": err, "bit_identical": True}
            if p.dx == "wgmma":
                case["schedule"] = schedule(E, C, D, F, gs_np)
                graph_dx(x, w, gs, dy, got[0], empty if C == 320 else small[::-1].copy())
                case["graph_bit_identical"] = True
            del want, again
            if is_timed and dtype == torch.bfloat16:
                es = x.element_size()
                rows = int(gs_np.sum())
                live_experts = int((gs_np > 0).sum())
                x_live, dy_live = rows * D * es, rows * F * es
                w_live = live_experts * D * F * es
                dx_out, dw_out = E * C * D * es, E * D * F * es
                flops = 2 * rows * D * F
                live = torch.arange(C, device="cuda")[None, :, None] < gs[:, None, None]
                xz, dyz = torch.where(live, x, 0), torch.where(live, dy, 0)
                wt = w.transpose(1, 2)
                timed(case, lambda: ops.moe_gmm_bwd(x, w, gs, dy),
                      lambda: ref.moe_gmm_bwd_ref(x, w, gs, dy),
                      lambda: (torch.bmm(dyz, wt), torch.bmm(xz.transpose(1, 2), dy)),
                      x_live + w_live + dy_live + 4 * E + dx_out + dw_out, 2 * flops)
                case["of_bound"] = case["ms"] / case["bound_ms"]
                # each gradient alone, beside its torch.bmm
                for name, kw, lib, nbytes in (
                        ("dx", dict(need_dw=False), lambda: torch.bmm(dyz, wt),
                         w_live + dy_live + 4 * E + dx_out),
                        ("dw", dict(need_dx=False), lambda: torch.bmm(xz.transpose(1, 2), dy),
                         x_live + dy_live + 4 * E + dw_out)):
                    fn = lambda kw=kw: ops.moe_gmm_bwd(x, w, gs, dy, **kw)  # noqa: E731
                    alone = {**kernel_times(fn), "library_ms": time_ms(lib),
                             "library_graph_ms": time_ms(lib, graph=True)}
                    alone["bound_ms"], alone["bound_by"] = bound(nbytes, flops, case["dtype"])
                    alone["of_bound"] = alone["ms"] / alone["bound_ms"]
                    case[name] = alone
            emit_case("moe_gmm_bwd", case)
            cases.append(case)
            del x, w, dy, got
    torch.cuda.empty_cache()
    return cases


def _rwkv6_scan_bwd_cases(seed: int) -> list:
    """K5's backward against its plain version, float32 as the model feeds it:
    rwkv6-3b's training shape (B 2, H 40, T 512, dh 64) with no final-state
    gradient (as in training: timed) and with one, and a T that is not a
    multiple of the 16-step checkpoints (T 200) with one; r/k/v/w and dout as
    (B, H, T, dh) views of (B, T, H, dh) memory, as the model passes them.
    Two calls must give the same bits, and the plan must put the training
    shape in one wave.  No single PyTorch call computes the reverse scan: no
    library time.  Bound: r, k, v, w, dout, u and s0 read once, dr, dk, dv,
    dw, du and ds0 written once (the checkpoints are the design's, not the
    function's); 15 dh^2 operations a step (the states recomputed once
    included)."""
    import torch

    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rwkv6_scan as k5
    from repro_torch.kernels import rwkv6_scan_bwd as k5b

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 23)

    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    cases = []
    for (B, H, T, dh), with_dsf, is_timed in (((2, 40, 512, 64), False, True),
                                              ((2, 40, 512, 64), True, False),
                                              ((2, 40, 200, 64), True, False)):
        r, k, v = (rnd(B, T, H, dh).transpose(1, 2) for _ in range(3))
        w = torch.sigmoid(rnd(B, T, H, dh, scale=1.0)).transpose(1, 2)
        u, s0 = rnd(H, dh, scale=0.3), rnd(B, H, dh, dh, scale=0.1)
        dout = rnd(B, T, H, dh, scale=1.0).transpose(1, 2)
        dsf = rnd(B, H, dh, dh) if with_dsf else None
        ck = torch.empty(k5.checkpoint_shape(B, H, T, dh), device="cuda")
        ops.rwkv6_scan(r, k, v, w, u, s0, checkpoints=ck)
        got = ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, dsf, checkpoints=ck)
        want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, dsf)
        tag = f"rwkv6_scan_bwd {B, H, T, dh} ds_final={with_dsf}"
        err = max(check_grad(f"{tag} {n}", a, b, 2e-4, 2e-4)
                  for n, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want))
        again = ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, dsf, checkpoints=ck)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: two calls differ")
        p = k5b.plan(B, H, T, dh, build.sm_count(0))
        case = {"shape": [B, H, T, dh], "dtype": "float32", "ds_final": with_dsf,
                "plan": p._asdict(), "path": "fma", "max_abs_err": err, "bit_identical": True}
        if (B, H, T, dh) == (2, 40, 512, 64) and p.waves != 1:
            raise AssertionError(f"{tag}: plan {p} is not one wave")
        if is_timed:
            n = B * H * T * dh
            nbytes = 4 * (9 * n + 2 * H * dh + 2 * B * H * dh * dh)
            timed(case, lambda: ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, dsf,
                                                   checkpoints=ck),
                  lambda: ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, dsf), None,
                  nbytes, 15 * B * H * T * dh * dh)
            case["of_bound"] = case["ms"] / case["bound_ms"]
            case["forward_with_checkpoints_ms"] = time_ms(
                lambda: ops.rwkv6_scan(r, k, v, w, u, s0, checkpoints=ck))
            case["forward_ms"] = time_ms(lambda: ops.rwkv6_scan(r, k, v, w, u, s0))
        emit_case("rwkv6_scan_bwd", case)
        cases.append(case)
    return cases


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().float().numpy()


def _train_batch(cfg, seed: int, batch: int, seq: int) -> dict:
    import numpy as np

    from repro_torch.training.data import DataConfig, SyntheticLM

    out = next(SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=seed)).batches())
    if cfg.family == "audio":
        rng = np.random.default_rng(seed)
        out["frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return out


def _first_update_err(opt_cfg, lr: float, before, params, m, v) -> float:
    """Largest |p - want| over the leaves after one AdamW step from zero
    moments, ``want`` computed on the CPU from the parameters before the step
    (numpy) and the step's own m and v: a missing or sign-flipped update is
    off by about lr."""
    import torch

    b1c, b2c = 1 - opt_cfg.b1, 1 - opt_cfg.b2
    err = 0.0
    for p0, p, m1, v1 in zip(before, params, m, v):
        p0, m1, v1 = torch.from_numpy(p0), m1.cpu(), v1.cpu()
        delta = (m1 / b1c) / (torch.sqrt(v1 / b2c) + opt_cfg.eps)
        if p0.ndim >= 2:
            delta = delta + opt_cfg.weight_decay * p0
        err = max(err, max_err(p.cpu(), p0 - lr * delta))
    return err


def _train_kernels(cfg) -> tuple:
    """The kernels a train step of ``cfg`` must launch, forward and backward
    by pairs: K1 where it has attention, K4 for moe, K5 for rwkv6 (which has
    no attention: it must launch no K1)."""
    kernels = () if cfg.family == "ssm" else ("flash_attention", "flash_attention_bwd")
    if cfg.is_moe:
        kernels += ("moe_gmm", "moe_gmm_bwd")
    if cfg.family == "ssm":
        kernels += ("rwkv6_scan", "rwkv6_scan_bwd")
    return kernels


def _train_smoke(seed: int) -> dict:
    """One f32 train step of a smoke arch of every family (moe and rwkv6
    included), on the card and on the CPU from the same numpy weights and
    batch; each must launch its family's kernels, forward and backward."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training import optim, trainer

    opt_cfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    out = {"archs": {}, "loss_atol": TRAIN_LOSS_ATOL, "grad_atol": TRAIN_GRAD_ATOL,
           "update_atol": TRAIN_UPDATE_ATOL}
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_arch(arch)
        tree = _numpy_tree(transformer.init_params(cfg, seed, device="cpu"))
        batch = _train_batch(cfg, seed, 2, 32)
        res = {}
        for device in ("cpu", "cuda"):
            p = transformer.params_from_numpy(tree, cfg, device=device)
            before = ops.launch_counts()
            loss, _, grads = trainer.loss_and_grads(p, cfg, trainer.batch_to(batch, device))
            launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
            step = trainer.make_train_step(cfg, opt_cfg, device=device)
            p, opt, stats = step(p, optim.init_opt_state(p), batch)
            res[device] = (float(loss), optim.tree_leaves(grads), float(stats["loss"]),
                           [optim.tree_leaves(t) for t in (p, opt["m"], opt["v"])],
                           launched, float(stats["lr"]))
        loss_err = abs(res["cuda"][0] - res["cpu"][0])
        step_loss_err = abs(res["cuda"][2] - res["cpu"][2])
        grad_err = max(max_err(a.cpu(), b) for a, b in zip(res["cuda"][1], res["cpu"][1]))
        # the step's own (clipped) gradients, m / (1 - b1) after one step
        b1c = 1 - opt_cfg.b1
        step_grad_err = max(max_err(a.cpu() / b1c, b / b1c)
                            for a, b in zip(res["cuda"][3][1], res["cpu"][3][1]))
        update_err = _first_update_err(opt_cfg, res["cuda"][5],
                                       optim.tree_leaves(tree), *res["cuda"][3])
        launched = res["cuda"][4]
        if max(loss_err, step_loss_err) > TRAIN_LOSS_ATOL \
                or max(grad_err, step_grad_err) > TRAIN_GRAD_ATOL \
                or update_err > TRAIN_UPDATE_ATOL:
            raise AssertionError(f"train {arch}: card vs CPU loss {loss_err} "
                                 f"{step_loss_err}, grads {grad_err} {step_grad_err}; "
                                 f"update {update_err}")
        must = _train_kernels(cfg)
        if not all(launched[k] for k in must) or (
                cfg.family == "ssm" and launched["flash_attention"]):
            raise AssertionError(f"train {arch}: kernels launched {launched}, want {must}")
        out["archs"][arch] = {"loss": res["cuda"][0], "loss_err": loss_err,
                              "step_loss_err": step_loss_err, "grad_max_abs_err": grad_err,
                              "step_grad_max_abs_err": step_grad_err,
                              "update_max_abs_err": update_err, "launches": launched}
    torch.cuda.empty_cache()
    return out


def _moe_bwd_in_model(params, cfg, batch) -> dict:
    """K4's backward inside one bf16 step of ``cfg``, held against its plain
    version on the same tensors: loss_and_grads runs with ops.moe_gmm_bwd
    recording the arguments and results of its first three calls (the last
    moe layer's down, up and gate products, in the model's own layouts,
    routing and dy), then each gradient is checked against moe_gmm_bwd_ref
    (2e-2, atol scaled to the largest |want|)."""
    import torch

    from repro_torch.kernels import moe_gmm_bwd as k4b
    from repro_torch.kernels import ops, ref
    from repro_torch.training import trainer

    kernel, calls = ops.moe_gmm_bwd, []

    def recording(x, w, group_sizes, dy, **kw):
        got = kernel(x, w, group_sizes, dy, **kw)
        if len(calls) < 3:
            calls.append((x, w, group_sizes, dy, kw, got))
        return got

    ops.moe_gmm_bwd = recording
    try:
        trainer.loss_and_grads(params, cfg, batch)
    finally:
        ops.moe_gmm_bwd = kernel
    if len(calls) != 3:
        raise AssertionError(f"moe backward in the model: {len(calls)} calls recorded")
    out = {"calls": []}
    for i, (x, w, gs, dy, kw, got) in enumerate(calls):
        want = ref.moe_gmm_bwd_ref(x, w, gs, dy)
        errs = {n: check_grad(f"moe_gmm_bwd in {cfg.name} call {i} {n}", a, b,
                              *_tol(x.dtype))
                for n, a, b in zip(("dx", "dw"), got, want) if a is not None}
        out["calls"].append({"shape": list(x.shape) + [w.shape[2]], "dtype": str(x.dtype)[6:],
                             "path": k4b.plan_call(x, w, dy)._asdict(),
                             "dy_strides": list(dy.stride()), "group_sizes": gs.tolist(),
                             "max_abs_err": errs,
                             "max_abs_want": {n: float(b.float().abs().max())
                                              for n, b in zip(("dx", "dw"), want)}})
        del want
    del calls
    torch.cuda.empty_cache()
    print(f"[moe_gmm_bwd in model] {json.dumps(out)}", file=sys.stderr, flush=True)
    return out


def _profile_parts(fn) -> tuple:
    """``fn()`` under torch.profiler: (its result, device microseconds summed
    by TRAIN_PARTS, the rest as ``other``, and the kernels summed into each
    part by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    parts = dict.fromkeys([p for p, _ in TRAIN_PARTS] + ["other"], 0.0)
    names = {p: {} for p in parts}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        part = next((p for p, frags in TRAIN_PARTS if any(f in e.key for f in frags)),
                    "other")
        parts[part] += us
        names[part][e.key[:90]] = names[part].get(e.key[:90], 0.0) + us
    top = dict(sorted(names["other"].items(), key=lambda kv: -kv[1])[:8])
    print(f"[train profile] {json.dumps(parts)} k1_bwd {json.dumps(names['k1_bwd'])} "
          f"top other {json.dumps(top)}", file=sys.stderr, flush=True)
    return result, parts, names


def _train_full_width(seed: int, card, arch: str, layers=None, steps: int = 5,
                      batch: int = 2, seq: int = 512) -> dict:
    """``arch`` at full width (bf16; ``layers`` of its layers where all do
    not fit the card: the cut is ``depth_cut``) from random weights: one
    warm-up train step, then ``steps`` on SyntheticLM data, timed on the host
    clock after a synchronise, under the card's energy counter (ms/step,
    tokens/s and J/token are over these ``steps``); then one more step under
    torch.profiler, split into forward + backward by part and the AdamW
    update.  The run fails on a loss that is not finite, parameters that do
    not move, a kernel launched other than once per call of its layers a
    step (K1 and its backward per attention layer, K4 and its backward three
    times per moe layer, K5 and its backward per rwkv6 layer), or a bf16
    backward kernel off the tensor cores; a moe arch's run also holds the
    last moe layer's three K4 backward calls of one more step against the
    plain version on their own tensors (``_moe_bwd_in_model``)."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training import optim, trainer
    from repro_torch.training.data import DataConfig, SyntheticLM

    cfg = get_arch(arch)
    depth_cut = None
    if layers is not None:
        depth_cut = f"{layers} of {cfg.num_layers} layers"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed, device="cuda")
    opt_state = optim.init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = trainer.make_train_step(cfg, optim.AdamWConfig(warmup_steps=1,
                                                             total_steps=steps),
                                      device="cuda")
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=seed)).batches()
    batches = [next(data) for _ in range(steps + 2)]   # data is set-up, made first
    # the largest leaf (the layers' stacked weights), 8 x 8 of its first slice
    big = max(optim.tree_leaves(params), key=lambda t: t.numel())
    probe = lambda: big.reshape(-1, big.shape[-1])[:8, :8].clone()  # noqa: E731
    before = probe()
    losses, step_ms = [], []

    def run(bs):
        for b in bs:
            t = time.perf_counter()
            _, _, stats = step_fn(params, opt_state, b)
            losses.append(float(stats["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)

    run(batches[:1])   # warm-up (cuBLAS, the allocator), outside the energy window
    ops.reset_launch_counts()
    _, energy = card.measure(lambda: run(batches[1:steps + 1]))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = steps * batch * seq
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"full-width train {arch}: losses {losses}")
    if torch.equal(before, probe()):
        raise AssertionError(f"full-width train {arch}: the parameters did not change")
    calls = {"flash_attention": cfg.num_layers, "moe_gmm": 3 * cfg.num_layers,
             "rwkv6_scan": cfg.num_layers}
    want = {k: steps * calls[k.removesuffix("_bwd")] for k in _train_kernels(cfg)}
    if any(launches[k] != n for k, n in want.items()) or \
            (cfg.family == "ssm" and launches["flash_attention"]):
        raise AssertionError(f"full-width train {arch}: launches {launches}, want {want}")
    tb = trainer.batch_to(batches[steps + 1], "cuda")
    (_, _, grads), fb, fb_names = _profile_parts(
        lambda: trainer.loss_and_grads(params, cfg, tb))
    # every bf16 backward call plans its tensor-core path
    off = [n for n in fb_names["k1_bwd"] if "attn_bwd_mma_" not in n
           and "attn_bwd_delta" not in n and "attn_bwd_dq_reduce" not in n]
    off += [n for n in fb_names["k4_bwd"] if "gmmbwd_fma" in n]
    if off or any(not fb_names[part] for part, kernel in (
            ("k1_bwd", "flash_attention_bwd"), ("k4_bwd", "moe_gmm_bwd"),
            ("k5_bwd", "rwkv6_scan_bwd")) if kernel in want):
        raise AssertionError(f"full-width train {arch}: backward kernels off the tensor "
                             f"cores {off}, or missing: {fb_names}")
    _, upd, _ = _profile_parts(lambda: optim.adamw_update(
        optim.AdamWConfig(warmup_steps=1, total_steps=steps), params, grads, opt_state))
    del grads
    moe_check = _moe_bwd_in_model(params, cfg, tb) if cfg.is_moe else None
    breakdown = dict(fb, adamw=sum(upd.values()))
    total = sum(breakdown.values())
    steady = step_ms[1:]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": str(cfg.torch_dtype)[6:],
           "batch": batch, "seq": seq, "steps": steps, "warmup_steps": 1,
           "depth_cut": depth_cut, "init_s": init_s,
           "params": sum(t.numel() for t in optim.tree_leaves(params)),
           "losses": losses, "step_ms": step_ms,
           "ms_per_step": sum(steady) / len(steady),
           "tokens_per_s": batch * seq / (sum(steady) / len(steady) / 1e3),
           "max_memory_allocated": peak, "card_j": energy["j"], "card_s": energy["s"],
           "card_w": energy["w"], "card_j_per_token": energy["j"] / tokens,
           "energy_method": card.method, "launches": launches,
           "moe_gmm_bwd_in_model": moe_check,
           "device_us": breakdown, "device_us_total": total,
           "backward_kernels_us": {p: fb_names[p] for p in ("k1_bwd", "k4_bwd", "k5_bwd")},
           "device_share": {k: v / total for k, v in breakdown.items()}}
    del params, opt_state, step_fn, big
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_small(seed: int) -> dict:
    """examples/torch_train_small.py at its default arguments on the card
    (the ~100M qwen3 variant, 200 steps, a checkpoint saved, loaded and
    served through SI2), held to: the held-out loss (the mean over its two
    eval batches) falls by >= 0.2 from the initial weights' to the trained
    tree's, and the loaded checkpoint serves the tokens the trained tree in
    memory serves."""
    import numpy as np
    import torch

    from repro_torch.core.engines import CompiledEngine
    from repro_torch.models import transformer
    from repro_torch.training import trainer
    from repro_torch.training.data import DataConfig, eval_batches

    twin = _twin("train_small")
    cfg = twin.model_config("qwen3-8b", 512, 8)
    ev = eval_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, batch_size=8), 2)

    def eval_loss(p):
        with torch.no_grad():
            return float(np.mean([float(trainer.lm_loss(p, cfg, trainer.batch_to(b, "cuda"))[0])
                                  for b in ev]))

    before = eval_loss(transformer.init_params(cfg, seed, device="cuda"))
    trained = []
    load = twin.load_checkpoint

    def load_checkpoint(path, template, *a, **k):
        trained.append(template)      # the trained tree the checkpoint came from
        return load(path, template, *a, **k)

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    twin.load_checkpoint = load_checkpoint
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            res, line = _run_twin("train_small", ["--ckpt", tmp, "--seed", str(seed)])
    finally:
        twin.load_checkpoint = load
    after = eval_loss(trained[0])
    if not before - after >= 0.2:
        raise AssertionError(f"train_small: held-out loss {before} -> {after}")
    if res["restored_step"] != res["steps"]:
        raise AssertionError(f"train_small: checkpoint step {res['restored_step']}")
    want = CompiledEngine(cfg, trained[0], res["seq"] + 32, device="cuda").generate(
        ev[0]["tokens"][:1, :16], 8).tokens[0]
    if not np.array_equal(want, res["tokens"]):
        raise AssertionError("train_small: the loaded checkpoint serves other tokens")
    return dict(line, arch=res["arch"], params=res["params"], steps=res["steps"],
                seq=res["seq"], batch=res["batch"], train_seconds=res["seconds"],
                eval_loss_before=before, eval_loss_after=after,
                eval_loss_restored_first_batch=res["eval_loss"],
                history=[(h["step"], h["loss"]) for h in res["history"]],
                checkpoint_bytes=res["checkpoint_bytes"], served_tokens_equal=True,
                served_tokens=res["tokens"])


def _train_cli() -> dict:
    """python -m repro_torch.launch.train at smoke size, on the card."""
    import torch

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "minitron-4b", "--smoke", "--steps", "5"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith("done:") or \
            not lines[0].endswith(f"device={torch.cuda.get_device_name(0)}"):
        raise AssertionError(f"launch.train exit {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-3000:]}")
    print("[launch.train]\n" + proc.stdout, file=sys.stderr, flush=True)
    return {"seconds": seconds, "stdout": lines}


def phase_train(seed: int) -> dict:
    """K1 with lse and the three backward kernels against their plain
    versions; smoke train steps card vs CPU; the full-width runs
    (TRAIN_FULL_WIDTH); the train_small flow; the CLI."""
    t_phase = time.perf_counter()
    out = {"phase": "train"}
    out["flash_attention_lse"], out["flash_attention_bwd"] = _train_attention_cases(seed)
    out["moe_gmm_bwd"] = _moe_gmm_bwd_cases(seed)
    out["rwkv6_scan_bwd"] = _rwkv6_scan_bwd_cases(seed)
    out["smoke"] = _train_smoke(seed)
    card = CardEnergy()
    try:
        out["full_width"] = []
        for arch, layers, steps in TRAIN_FULL_WIDTH:
            run = _train_full_width(seed, card, arch, layers, steps)
            emit(dict(run, phase="train_run"))
            out["full_width"].append(run)
    finally:
        card.close()
    out["train_small"] = _train_small(seed)
    out["cli"] = _train_cli()
    # the main path's launches: the full-width runs' loops and train_small's
    # (its loop, its eval, its SI2 serve of the checkpoint)
    runs = out["full_width"] + [out["train_small"]]
    out["launches"] = {k: sum(r["launches"][k] for r in runs) for k in KERNEL_SOURCES}
    out["graph_replay_launches"] = dict(out["train_small"]["graph_replay_launches"])
    out["seconds"] = time.perf_counter() - t_phase
    emit({k: v for k, v in out.items() if k not in ("flash_attention_lse",
                                                    *BACKWARD_KERNELS)})
    return out


# -- the examples phase -------------------------------------------------------------


def _twin(name: str):
    """examples/torch_<name>.py as a module (examples/ is no package)."""
    import importlib.util

    key = f"torch_{name}"
    if key not in sys.modules:
        path = os.path.join(ROOT, "examples", f"{key}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    return sys.modules[key]


@contextlib.contextmanager
def _captured_graphs():
    """Every decode and B = 1 prefill graph an SI2 engine captures while
    open, so that the launches its replays make can be counted (the
    wrappers' counters see only the capture)."""
    from repro_torch.core.engines import CompiledEngine

    graphs = []
    originals = {name: getattr(CompiledEngine, name) for name in ("_capture", "_capture_prefill")}

    def recording(capture):
        def record(self, arg):
            graphs.append(capture(self, arg))
            return graphs[-1]
        return record

    for name, capture in originals.items():
        setattr(CompiledEngine, name, recording(capture))
    try:
        yield graphs
    finally:
        for name, capture in originals.items():
            setattr(CompiledEngine, name, capture)


def _run_twin(name: str, argv: list) -> tuple:
    """``main`` of examples/torch_<name>.py on the card, its printout sent
    to stderr: (its result, one line of seconds, peak memory and launches,
    eager and by graph replay, printed on stdout)."""
    import gc

    import torch

    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _captured_graphs() as graphs, contextlib.redirect_stdout(sys.stderr):
        print(f"[torch_{name}] {' '.join(argv)}", flush=True)
        res = _twin(name).main(argv + ["--device", "cuda"])
        sys.stdout.flush()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    line = {"phase": "example", "twin": f"examples/torch_{name}.py", "argv": argv,
            "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "graph_replay_launches": {k: sum(g.launches_per_replay[k] * g.replays
                                             for g in graphs) for k in launches},
            "graphs": len(graphs)}
    emit(line)
    return res, line


# the twins at their default (smoke) arguments; quickstart and serve_batched
# also at full width below, train_small in the train phase
EXAMPLE_TWINS = ("green_comparison", "sweep_decisions", "serve_fleet", "serve_disagg",
                 "serve_chaos", "carbon_shift", "serve_monitored", "serve_traced")


def phase_examples(seed: int) -> dict:
    """The twins of examples/*.py through their own ``main``: quickstart
    (SI1 -> SI4) and serve_batched (SI3 over the binary codec) at full-width
    minitron-4b, their other arguments at the defaults; then every other
    twin once at its default (smoke) arguments.  Fails on a twin that
    raises, on quickstart's SI1, SI2 and SI3 serving other greedy tokens, on
    K1 or K2 launched no time inside quickstart or serve_batched, and on K3
    launched no time inside sweep_decisions (its bulk endpoint serves
    rsm_int8)."""
    import shutil

    t_phase = time.perf_counter()
    seed_args = ["--seed", str(seed)]
    # quickstart's SI4 uploads the weights in rsm to a temp directory
    disk_free = shutil.disk_usage(tempfile.gettempdir()).free
    cfg, params, need, depth_cut = _api_depth(seed, disk_free, ("rsm",))
    del params
    out = {"phase": "examples", "arch": cfg.name, "layers": cfg.num_layers,
           "depth_cut": depth_cut, "temp_disk_free": disk_free,
           "registry_bytes_expected": need, "twins": {}}
    lines = []
    with _registered(cfg):
        res, line = _run_twin("quickstart", ["--arch", cfg.name] + seed_args)
        tokens = [res[si]["tokens"] for si in ("si1", "si2", "si3", "si4")]
        if not tokens[0] == tokens[1] == tokens[2]:
            raise AssertionError(f"quickstart: SI1, SI2 and SI3 serve other tokens: {tokens[:3]}")
        out["twins"]["quickstart"] = dict(
            line, tokens_si1_si2_si3_equal=True, tokens_si4_equal=tokens[3] == tokens[0],
            tokens=tokens[0], summaries={si: res[si]["summary"] for si in
                                         ("si1", "si2", "si3", "si4")},
            si2_build_s=res["si2"]["build_s"], si4_replicas=res["si4"]["replicas"])
        lines.append(line)
        res, line = _run_twin("serve_batched", ["--arch", cfg.name] + seed_args)
        out["twins"]["serve_batched"] = dict(line, summary=res["summary"], wire=res["wire"],
                                             tokens=res["tokens"])
        lines.append(line)
    for name in ("quickstart", "serve_batched"):
        counts = out["twins"][name]["launches"]
        if not counts["flash_attention"] or not counts["decode_attention"]:
            raise AssertionError(f"{name}: K1 or K2 not launched: {counts}")
    for name in EXAMPLE_TWINS:
        res, line = _run_twin(name, list(seed_args))
        out["twins"][name] = dict(line, result=res)
        lines.append(line)
        if res.get("status", 0):
            raise AssertionError(f"torch_{name}: status {res['status']}")
    if not out["twins"]["sweep_decisions"]["launches"]["int8_matmul"]:
        raise AssertionError("sweep_decisions: K3 not launched (its bulk endpoint serves "
                             "rsm_int8)")
    out["launches"] = {k: sum(ln["launches"][k] for ln in lines) for k in KERNEL_SOURCES}
    out["graph_replay_launches"] = {k: sum(ln["graph_replay_launches"][k] for ln in lines)
                                    for k in KERNEL_SOURCES}
    out["seconds"] = time.perf_counter() - t_phase
    emit({k: v for k, v in out.items() if k != "twins"})
    print(json.dumps(out, default=str), file=sys.stderr, flush=True)
    return out


# the dry-run sweep's archs: one of each family (the CLI runs all ten)
DRYRUN_ARCHS = ("minitron-4b", "mixtral-8x7b", "rwkv6-3b", "zamba2-2.7b", "whisper-small")
DRYRUN_WORKERS = 8      # the card's host has 8 cores
# the card check: (kind, batch, sequence) of full-width minitron-4b's step, as
# the serve phase prefills (B 4 x 512, max_seq 512), one decode step (B 4
# against a 1024-entry cache) and the train phase's step (B 2 x S 512, with
# the dry-run's bf16 optimizer state and remat)
DRYRUN_CARD_STEPS = (("prefill", 4, 512), ("decode", 4, 1024), ("train", 2, 512))
DRYRUN_RATIO = (0.85, 1.15)   # predicted / measured peak bytes a device


# a worker of the sweep: its share of the combos, one process, one record each
_SWEEP_WORKER = """
import json, sys, traceback
from repro_torch.launch import dryrun
for arch, shape, mesh in json.loads(sys.argv[2]):
    try:
        dryrun.run_one(arch, shape, mesh == "multi", sys.argv[1])
    except Exception:
        print("FAIL", arch, shape, mesh, flush=True)
        traceback.print_exc()
"""


# left out of the sweep to make room for the examples phase: zamba2's train
# step on the 16x16 mesh, the sweep's longest trace (249 s of its 271 s on
# the card's host); its 2x16x16 trace stays, and the CLI traces both
DRYRUN_SKIP = (("zamba2-2.7b", "train_4k", "single"),)

# seconds each combo's trace took on the card's host, eight at a time, to
# balance the workers; the rest took 1-8 s
_SWEEP_SECONDS = {
    ("zamba2-2.7b", "train_4k", "multi"): 142, ("mixtral-8x7b", "train_4k", "single"): 124,
    ("rwkv6-3b", "train_4k", "single"): 115, ("mixtral-8x7b", "train_4k", "multi"): 86,
    ("minitron-4b", "train_4k", "single"): 83, ("rwkv6-3b", "train_4k", "multi"): 69,
    ("zamba2-2.7b", "prefill_32k", "multi"): 65, ("zamba2-2.7b", "prefill_32k", "single"): 61,
    ("minitron-4b", "train_4k", "multi"): 55, ("whisper-small", "train_4k", "single"): 43,
    ("whisper-small", "train_4k", "multi"): 31,
}


class DryrunSweep:
    """The dry-run's sweep over DRYRUN_ARCHS' applicable shapes on both
    meshes, but DRYRUN_SKIP: DRYRUN_WORKERS processes with the card hidden
    (fake ranks trace on fake CPU tensors and hold no device memory), each
    running its share of the combos, longest first, balanced by
    ``_SWEEP_SECONDS``.  Started after the card's phases, so that no
    host-timed number shares the CPU."""

    def __init__(self, out_dir: str):
        from repro_torch.configs import SHAPES, applicable, get_arch, get_shape

        self.out_dir = out_dir
        combos = [(a, s, m) for a in DRYRUN_ARCHS for s in sorted(SHAPES)
                  for m in ("single", "multi") if applicable(get_arch(a), get_shape(s))
                  and (a, s, m) not in DRYRUN_SKIP]
        self.combos = sorted(combos, key=lambda c: -_SWEEP_SECONDS.get(c, 8))
        shares, load = [[] for _ in range(DRYRUN_WORKERS)], [0] * DRYRUN_WORKERS
        for c in self.combos:
            w = load.index(min(load))
            shares[w].append(c)
            load[w] += _SWEEP_SECONDS.get(c, 8)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.path.join(ROOT, "src"))
        os.makedirs(out_dir, exist_ok=True)
        self.t0 = time.perf_counter()
        self.logs, self.procs = [], []
        for i, share in enumerate(s for s in shares if s):
            log = open(os.path.join(out_dir, f"worker{i}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _SWEEP_WORKER, out_dir, json.dumps(share)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))

    def stop(self):
        """Kill whatever still runs (a failed phase ends the script)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()

    def finish(self) -> list:
        for p in self.procs:
            p.wait()
        lines, fails = [], []
        for log, p in zip(self.logs, self.procs):
            log.close()
            with open(log.name) as f:
                text = f.read()
            if p.returncode or "FAIL" in text:
                print(f"[dryrun worker rc {p.returncode}] {text[-4000:]}", file=sys.stderr)
        for arch, shape, mesh in self.combos:
            path = os.path.join(self.out_dir, f"{arch}_{shape}_{mesh}.json")
            if not os.path.exists(path):
                fails.append(f"{arch} x {shape} x {mesh}")
                continue
            with open(path) as f:
                rec = json.load(f)
            coll = rec["collectives"]
            line = {"phase": "dryrun", "arch": arch, "shape": shape, "mesh": mesh,
                    "kind": rec["kind"], "chips": rec["chips"],
                    "peak_gb": rec["memory"]["peak_bytes_per_device"] / 1e9,
                    "argument_gb": rec["memory"]["argument_size_in_bytes"] / 1e9,
                    "fits_80gb": rec["fits_80gb"], "flops": rec["cost"]["flops"],
                    "collective_bytes": {k: coll[k] for k in (
                        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                        "collective-permute")},
                    "collective_count": coll["count"], "fallbacks": rec["fallbacks"],
                    "trace_s": rec["trace_s"]}
            emit(line)
            lines.append(line)
        if fails:
            raise AssertionError(f"dryrun: {len(fails)} combos failed: {fails}")
        return lines


def _card_step(cfg, kind: str, batch: int, seq: int, params, seed: int):
    """The real step of (kind, batch, seq) on the card, its arguments made
    first: (arguments, step) with the step a no-argument callable."""
    import torch

    from repro_torch.launch.specs import microbatches_for
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import transformer
    from repro_torch.training import optim, trainer

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    if kind == "prefill":
        args = {"tokens": tokens}
        return args, lambda: transformer.prefill(params, cfg, args, max_seq=seq)
    if kind == "decode":
        cache = transformer.init_cache(cfg, batch, seq, device="cuda")
        cache["lengths"].fill_(seq // 2)
        new = tokens[:, 0].contiguous()
        return (cache, new), lambda: transformer.decode_step(params, cfg, cache, new)
    opt_state = optim.init_opt_state(params, dtype=torch.bfloat16)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    b = {"tokens": tokens, "labels": labels}
    mb = microbatches_for(cfg, ShapeConfig("card", seq, batch, "train"), 1)
    step = trainer.make_train_step(cfg, optim.AdamWConfig(), remat=True, microbatches=mb,
                                   device="cuda")
    return (opt_state, b), lambda: step(params, opt_state, b)


def _dryrun_card_check(seed: int, card_name: str) -> tuple:
    """The dry-run's record of full-width minitron-4b on ``make_host_mesh()``
    (1x1, the card) beside the same step run for real: for each of
    DRYRUN_CARD_STEPS, the peak statistics are reset with the step's
    arguments resident, the step runs with its kernels, and the prediction's
    peak_bytes_per_device is held against torch.cuda.max_memory_allocated()
    (DRYRUN_RATIO).  The trace itself must launch nothing."""
    import gc

    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.distributed.stats import memory_stats
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    cfg = get_arch("minitron-4b")
    mesh = mesh_lib.make_host_mesh()
    if mesh.device_type != "cuda" or mesh.size() != 1:
        raise AssertionError(f"dryrun: the host mesh is {mesh}, not the card")
    params = transformer.init_params(cfg, seed, device="cuda")
    checks, launches = [], dict.fromkeys(KERNEL_SOURCES, 0)
    try:
        for kind, batch, seq in DRYRUN_CARD_STEPS:
            ops.reset_launch_counts()
            t = time.perf_counter()
            trace, traced_kind, _ = dryrun.trace_step(
                cfg, ShapeConfig(f"card_{kind}", seq, batch, kind), mesh)
            trace_s = time.perf_counter() - t
            if traced_kind != kind or any(ops.launch_counts().values()):
                raise AssertionError(f"dryrun: the {kind} trace launched "
                                     f"{ops.launch_counts()}")
            mem = memory_stats(trace)
            del trace
            args, step = _card_step(cfg, kind, batch, seq, params, seed)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ops.reset_launch_counts()
            grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
            with grad:
                out = step()
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated()
            counts = ops.launch_counts()
            for k, v in counts.items():
                launches[k] += v
            del out, args, step
            gc.collect()
            torch.cuda.empty_cache()
            ratio = mem["peak_bytes_per_device"] / measured
            row = {"phase": "dryrun_card", "arch": cfg.name, "kind": kind, "batch": batch,
                   "seq": seq, "predicted_peak_bytes": mem["peak_bytes_per_device"],
                   "predicted_argument_bytes": mem["argument_size_in_bytes"],
                   "predicted_temp_bytes": mem["temp_size_in_bytes"],
                   "predicted_output_bytes": mem["output_size_in_bytes"],
                   "predicted_alias_bytes": mem["alias_size_in_bytes"],
                   "resident_bytes": resident, "max_memory_allocated": measured,
                   "ratio": ratio, "trace_s": trace_s, "launches": counts,
                   "gpu": card_name}
            emit(row)
            checks.append(row)
            if not DRYRUN_RATIO[0] <= ratio <= DRYRUN_RATIO[1]:
                raise AssertionError(f"dryrun: {kind} predicted {mem['peak_bytes_per_device']}"
                                     f" B, measured {measured} B: ratio {ratio:.4f} outside "
                                     f"{DRYRUN_RATIO}")
            if not any(counts[k] for k in SERVE_KERNELS):
                raise AssertionError(f"dryrun: the real {kind} step launched no kernel")
    finally:
        del params
        mesh_lib.release()
        gc.collect()
        torch.cuda.empty_cache()
    return checks, launches


def phase_dryrun(sweep: DryrunSweep, card_check: tuple) -> dict:
    """The dry-run: the card check (run first, in a clean process, by
    ``_dryrun_card_check``), then the sweep's records."""
    t_phase = time.perf_counter()
    checks, launches = card_check
    lines = sweep.finish()
    out = {"phase": "dryrun", "gpu": smi(),
           "ratios": {c["kind"]: c["ratio"] for c in checks},
           "combos": len(lines), "sweep_s": time.perf_counter() - sweep.t0,
           "fits_80gb": sum(r["fits_80gb"] for r in lines),
           "launches": launches,
           "graph_replay_launches": dict.fromkeys(launches, 0),
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def kernel_line(kernel_cases: dict, serve: dict, schedule: dict, fleet: dict,
                api: dict, train: dict, examples: dict, dryrun: dict) -> dict:
    """One entry per kernel, its numbers at one main-path shape (in bf16; K5
    in f32, as the model feeds it; K1's backward at minitron-4b's training
    shape); every timed case under timed_cases.  ``launches`` sums the serve,
    schedule, fleet, api, train, examples and dryrun paths' counts (eager)."""
    paths = {"serve": serve, "schedule": schedule, "fleet": fleet, "api": api,
             "train": train, "examples": examples, "dryrun": dryrun}
    main_shape = {"flash_attention": [4, 24, 8, 512, 128],
                  "flash_attention_bwd": [2, 24, 8, 512, 128],
                  "decode_attention": [4, 8, 3, 1024, 128],
                  "int8_matmul": [4, 3072, 9216],
                  "moe_gmm": [8, 8, 4096, 14336],
                  "moe_gmm_bwd": [8, 320, 4096, 14336],
                  "rwkv6_scan": [4, 40, 1, 64],
                  "rwkv6_scan_bwd": [2, 40, 512, 64]}
    entries = []
    for name, cases in kernel_cases.items():
        main = next(c for c in cases
                    if c["shape"] == main_shape[name] and "ms" in c
                    and c.get("window") is None)
        source, replaces = KERNEL_SOURCES[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {path: p["launches"][name] for path, p in paths.items()},
            "launches_by_arch": {arch: a["launches"][name]
                                 for arch, a in serve["archs"].items()},
            "graph_replay_launches": sum(p["graph_replay_launches"][name]
                                         for p in paths.values()),
            "graph_replay_launches_by_path": {path: p["graph_replay_launches"][name]
                                              for path, p in paths.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "graph_ms": main["graph_ms"],
            "library_graph_ms": main["library_graph_ms"], "shape": main["shape"],
            "timed_cases": [c for c in cases if "ms" in c],
        })
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    # a reference states its float32 matmul precision: true float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", file=sys.stderr)

    phase_build()
    # memory is compared in a process that holds nothing else yet
    card_check = _dryrun_card_check(args.seed, smi())
    kernels = phase_kernels(args.seed)
    phase_model_parity(args.seed)
    serve = phase_serve(args.seed)
    schedule = phase_schedule(args.seed)
    fleet = phase_fleet(args.seed)
    api = phase_api(args.seed)
    phase_formats(args.seed)
    train = phase_train(args.seed)
    examples = phase_examples(args.seed)
    sweep = DryrunSweep(os.path.join(ROOT, "chiprun_out", "dryrun"))
    try:
        dryrun = phase_dryrun(sweep, card_check)
    finally:
        sweep.stop()
    kernels["flash_attention"] = kernels["flash_attention"] + train["flash_attention_lse"]
    for name in BACKWARD_KERNELS:
        kernels[name] = train[name]
    emit(kernel_line(kernels, serve, schedule, fleet, api, train, examples, dryrun))
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
