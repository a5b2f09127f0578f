#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line:
  build         nvcc builds every kernel of csrc/ for sm_90a
  kernels       each kernel against its plain PyTorch version on the card,
                at minitron-4b's shapes, with its time, bound and the time of
                one PyTorch library call computing the same function
  model_parity  minitron-4b-smoke in f32: prefill + 3 decode steps on the
                card (kernels) against the CPU (plain versions), rsm and
                rsm_int8
  serve         full-width minitron-4b (32 layers, bf16, random weights from
                --seed) serves 8 requests through the binary codec, in rsm and
                rsm_int8, through SI1 (eager) and SI2 (CUDA graphs); the
                launch counters show the kernels on the path
  formats       rsm_int8 on disk -> load -> the same tokens as in memory;
                an 8-layer model serves rsm_int8 behind the norm-gain fence
Then the kernel summary line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero.  Without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
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
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- timing ----------------------------------------------------------------------


def time_ms(fn, iters: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` launches, L2 flushed before each."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    for name, r in report.items():
        lines = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[nvcc {name}]\n" + "\n".join(lines), file=sys.stderr)
    out = {"phase": "build", "seconds": seconds,
           "nvcc_seconds": {k: r["seconds"] for k, r in report.items()},
           "built": {k: r["built"] for k, r in report.items()},
           "gpu": smi()}
    emit(out)
    return out


def _tol(dtype):
    import torch

    return (2e-2, 2e-2) if dtype == torch.bfloat16 else (2e-4, 2e-4)


def phase_kernels(seed: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    results = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # K1: prefill attention, q/k/v in the model's (B, S, heads, dh) layout
    cases = []
    for (B, H, K, S, dh, window) in [(4, 24, 8, 512, 128, None), (2, 6, 2, 96, 32, 17),
                                     (1, 8, 8, 128, 64, None)]:
        for dtype in (torch.bfloat16, torch.float32):
            qm = randn(B, S, H, dh, dtype=dtype)
            km = randn(B, S, K, dh, dtype=dtype)
            vm = randn(B, S, K, dh, dtype=dtype)
            q, k, v = qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2)
            got = ops.flash_attention(q, k, v, causal=True, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
            err = check_close(f"flash_attention {B,H,K,S,dh,window} {dtype}", got, want,
                              *_tol(dtype))
            case = {"shape": [B, H, K, S, dh], "window": window,
                    "dtype": str(dtype)[6:], "max_abs_err": err}
            if (S, window) == (512, None):
                es = qm.element_size()
                nbytes = (2 * B * S * H * dh + 2 * B * S * K * dh) * es
                flops = 4 * B * H * dh * S * (S + 1) / 2
                case["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
                case["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(q, k, v), 3)
                case["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
                case["bound_ms"], case["bound_by"] = bound(nbytes, flops, case["dtype"])
            cases.append(case)
    results["flash_attention"] = cases

    # K2: decode attention over a (B, S, K, dh) cache, ragged lengths
    cases = []
    for (B, K, G, S, dh, window) in [(4, 8, 3, 1024, 128, None), (4, 8, 3, 1024, 128, 128),
                                     (3, 4, 1, 96, 64, None), (2, 2, 4, 128, 32, None)]:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(B, K, G, dh, dtype=dtype)
            kc = randn(B, S, K, dh, dtype=dtype).transpose(1, 2)
            vc = randn(B, S, K, dh, dtype=dtype).transpose(1, 2)
            lengths = torch.tensor([S, S * 3 // 4 + 9, S // 2 + 1, 100][:B],
                                   dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, kc, vc, lengths, window=window)
            want = ref.decode_attention_ref(q, kc, vc, lengths, window=window)
            err = check_close(f"decode_attention {B,K,G,S,dh,window} {dtype}", got, want,
                              *_tol(dtype))
            case = {"shape": [B, K, G, S, dh], "window": window,
                    "lengths": lengths.tolist(), "dtype": str(dtype)[6:],
                    "max_abs_err": err}
            if (S, window) == (1024, None):
                es = q.element_size()
                n_read = int(lengths.sum())
                nbytes = (2 * q.numel() + 2 * n_read * K * dh) * es + 4 * B
                flops = 4 * n_read * K * G * dh
                mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])
                mask = mask[:, None, None, :]
                qh = q.reshape(B, K * G, 1, dh)
                case["ms"] = time_ms(lambda: ops.decode_attention(q, kc, vc, lengths))
                case["plain_ms"] = time_ms(
                    lambda: ref.decode_attention_ref(q, kc, vc, lengths), 3)
                case["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kc, vc, attn_mask=mask, enable_gqa=True))
                case["bound_ms"], case["bound_by"] = bound(nbytes, flops, case["dtype"])
            cases.append(case)
    results["decode_attention"] = cases

    # K3: int8 weight-only GEMM, decode (M=4) and prefill (M=B*S=2048), at
    # every dense() shape of a minitron-4b layer: wq/wo, wk/wv, MLP wi, MLP wo
    # (M=4 runs them with 11, 32, 4 and 11 splits of D, M=2048 with 1, 3, 1, 1)
    cases = []
    for M in (4, 2048):
        for (D, N) in ((3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072)):
            for dtype in (torch.bfloat16, torch.float32):
                x = randn(M, D, dtype=dtype)
                wq, scales = ops.quantize_int8(randn(D, N, dtype=torch.float32) * D ** -0.5)
                got = ops.int8_matmul(x, wq, scales)
                want = ref.int8_matmul_ref(x, wq, scales)
                tol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-3, 1e-3)
                err = check_close(f"int8_matmul {M,D,N} {dtype}", got, want, *tol)
                case = {"shape": [M, D, N], "dtype": str(dtype)[6:], "max_abs_err": err}
                if dtype == torch.bfloat16:
                    es = x.element_size()
                    nbytes = (M * D + M * N) * es + D * N + 4 * N
                    flops = 2 * M * D * N
                    w_deq = (wq.float() * scales[None, :]).to(dtype)
                    case["ms"] = time_ms(lambda: ops.int8_matmul(x, wq, scales))
                    case["plain_ms"] = time_ms(lambda: ref.int8_matmul_ref(x, wq, scales), 3)
                    case["library_ms"] = time_ms(lambda: torch.matmul(x, w_deq))
                    case["bound_ms"], case["bound_by"] = bound(nbytes, flops, case["dtype"])
                cases.append(case)
    results["int8_matmul"] = cases
    # K3's share of one rsm_int8 prefill: each layer runs wq, wk, wv, wo (attention)
    # and wi, wo (MLP) at M=2048
    ms = {tuple(c["shape"][1:]): c["ms"] for c in cases
          if c["shape"][0] == 2048 and "ms" in c}
    layer = (2 * ms[(3072, 3072)] + 2 * ms[(3072, 1024)] + ms[(3072, 9216)]
             + ms[(9216, 3072)])
    emit({"phase": "kernels", "cases": results,
          "int8_matmul_ms_per_prefill_layer": layer,
          "int8_matmul_ms_per_prefill_32_layers": 32 * layer})
    return results


def _tree_to(tree, device):
    from repro_torch.serving.formats import QTensor

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.wq.to(device), tree.scales.to(device))
    return tree.to(device)


def phase_model_parity(seed: int) -> dict:
    """minitron-4b-smoke, f32: kernels on the card vs plain versions on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params

    cfg = get_arch("minitron-4b-smoke")
    cpu_params = transformer.init_params(cfg, seed, device="cpu")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32))
    out = {"phase": "model_parity", "arch": cfg.name, "dtype": cfg.dtype, "atol": 1e-3}
    for fmt in ("rsm", "rsm_int8"):
        p_cpu = quantize_params(cpu_params) if fmt == "rsm_int8" else cpu_params
        p_gpu = _tree_to(p_cpu, "cuda")
        with torch.no_grad():
            l_cpu, c_cpu = transformer.prefill(p_cpu, cfg, {"tokens": prompt}, 32)
            l_gpu, c_gpu = transformer.prefill(p_gpu, cfg, {"tokens": prompt.cuda()}, 32)
            errs = [check_close(f"{fmt} prefill", l_gpu.cpu(), l_cpu, 1e-3, 0.0)]
            tok = torch.argmax(l_cpu, -1).to(torch.int32)
            for step in range(3):
                l_cpu, c_cpu = transformer.decode_step(p_cpu, cfg, c_cpu, tok)
                l_gpu, c_gpu = transformer.decode_step(p_gpu, cfg, c_gpu, tok.cuda())
                errs.append(check_close(f"{fmt} decode {step}", l_gpu.cpu(), l_cpu,
                                        1e-3, 0.0))
                tok = torch.argmax(l_cpu, -1).to(torch.int32)
        out[fmt] = {"max_abs_err": max(errs)}
    emit(out)
    return out


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


def phase_serve(seed: int, n_requests: int = 8, prompt_len: int = 512,
                max_new: int = 32, batch: int = 4, max_seq: int = 1024) -> dict:
    """The main path at full width: minitron-4b, rsm and rsm_int8, SI1 and SI2."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.engines import CompiledEngine, EagerEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.formats import quantize_params

    cfg = get_arch("minitron-4b")
    L = cfg.num_layers
    dense_per_layer = 6
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed, device="cuda")
    trees = {"rsm": params, "rsm_int8": quantize_params(params)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len, dtype=np.int32)
               for _ in range(n_requests)]
    n_batches = -(-n_requests // batch)
    steps = max_new - 1

    out = {"phase": "serve", "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "requests": n_requests, "prompt_len": prompt_len,
           "max_new_tokens": max_new, "batch": batch, "max_seq": max_seq,
           "init_s": init_s, "runs": {}}
    tokens = {}
    graph_launches = {k: 0 for k in ops.launch_counts()}
    ops.reset_launch_counts()
    for fmt, tree in trees.items():
        int8 = fmt == "rsm_int8"
        # SI1: every launch goes through the wrappers' counters
        eng = EagerEngine(cfg, tree, max_seq)
        with torch.no_grad():
            logits, cache = eng.prefill_one(np.stack(prompts[:batch]))
            logits2, _ = eng.decode_batch(cache, torch.argmax(logits, -1))
        if not (torch.isfinite(logits).all() and torch.isfinite(logits2).all()):
            raise AssertionError(f"{fmt}: non-finite logits")
        before = ops.launch_counts()
        answers, results = _serve(eng, prompts, max_new, batch)
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = {"flash_attention": L * n_batches,
                "decode_attention": L * steps * n_batches,
                "int8_matmul": (L * dense_per_layer * (steps + 1) * n_batches
                                if int8 else 0)}
        if counts != want:
            raise AssertionError(f"{fmt} SI1 launches {counts} != {want}")
        tokens[(fmt, "SI1")] = answers
        out["runs"][f"{fmt}/SI1"] = _run_stats(results, batch, max_new, counts)

        # SI2: prefill eager, decode replays one captured graph per batch size
        eng2 = CompiledEngine(cfg, tree, max_seq)
        capture_s = eng2.warmup(batch, prompt_len)
        g = eng2.graphs[batch]
        replays0 = g.replays
        before = ops.launch_counts()
        answers2, results2 = _serve(eng2, prompts, max_new, batch)
        counts2 = {k: v - before[k] for k, v in ops.launch_counts().items()}
        replays = g.replays - replays0
        per_step = {"flash_attention": 0, "decode_attention": L,
                    "int8_matmul": L * dense_per_layer if int8 else 0}
        if g.launches_per_replay != per_step or replays != steps * n_batches:
            raise AssertionError(f"{fmt} SI2 graph {g.launches_per_replay} x {replays}")
        # outside the graph only the eager prefills launch: no eager decode step
        want2 = {"flash_attention": L * n_batches, "decode_attention": 0,
                 "int8_matmul": L * dense_per_layer * n_batches if int8 else 0}
        if counts2 != want2:
            raise AssertionError(f"{fmt} SI2 launches outside the graph {counts2} != {want2}")
        for rid, toks in answers2.items():
            if not np.array_equal(toks, answers[rid]):
                raise AssertionError(f"{fmt}: SI2 tokens of request {rid} differ from SI1")
        tokens[(fmt, "SI2")] = answers2
        stats = _run_stats(results2, batch, max_new, counts2)
        stats.update(capture_s=capture_s, graph_replays=replays,
                     launches_per_replay=g.launches_per_replay)
        out["runs"][f"{fmt}/SI2"] = stats
        for k, n in g.launches_per_replay.items():
            graph_launches[k] += n * g.replays
        del eng, eng2, g, cache
        torch.cuda.empty_cache()
    a = np.stack([tokens[("rsm", "SI1")][r] for r in range(n_requests)])
    b = np.stack([tokens[("rsm_int8", "SI1")][r] for r in range(n_requests)])
    out["int8_token_agreement"] = float((a == b).mean())
    out["answered"] = len(tokens[("rsm_int8", "SI2")])
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["launches"] = ops.launch_counts()
    out["graph_replay_launches"] = graph_launches
    emit(out)
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


def kernel_line(kernel_cases: dict, serve: dict) -> dict:
    """One entry per kernel, its numbers at the main path's bf16 shape."""
    main_shape = {"flash_attention": [4, 24, 8, 512, 128],
                  "decode_attention": [4, 8, 3, 1024, 128],
                  "int8_matmul": [4, 3072, 9216]}
    entries = []
    for name, cases in kernel_cases.items():
        main = next(c for c in cases
                    if c["shape"] == main_shape[name] and c["dtype"] == "bfloat16"
                    and c.get("window") is None)
        source, replaces = KERNEL_SOURCES[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve["launches"][name],
            "graph_replay_launches": serve["graph_replay_launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
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
    kernels = phase_kernels(args.seed)
    phase_model_parity(args.seed)
    serve = phase_serve(args.seed)
    phase_formats(args.seed)
    emit(kernel_line(kernels, serve))
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
