"""Where K4's bf16 dx spends its time, unit by unit, on one GPU.

    python3 scripts/torch_dx_timeline.py [--seed N] [--reps N]

``ncu`` does not run on the card's machine, so this script makes an
instrumented copy of ``src/repro_torch`` under ``build/timeline/`` (the
kernel source with ``%globaltimer`` reads added by string edits that fail
loudly if the source has moved on), builds it, and runs dx at
mixtral-8x7b's training gate/up and down (E 8, C 320, a uniform router's
2048 rows; the same inputs as ``chip_smoke.py``).  Consumer thread 0 of
every block records when each of its units (whole tiles, then its stream-K
piece) ends its products, ends its wait for the other pieces' sums, and
ends its epilogue.  Printed per unit index, over the blocks that ran one:
min / median / max of the products' time, the wait and the epilogue, and
when the unit ended (microseconds from the first block's start); then the
kernel's span.  Before that, the card's SM clock and draw sampled by
``nvidia-smi`` in the last two of four seconds of dx in a loop (the
board's draw is an average that lags the load).  The timestamps cost a
few stores a unit; the copy is never imported by the port.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "timeline")
SLOTS = 64   # timestamps a block: start, then 3 a unit, the unit count last

# (file under kernels/, anchor, text that replaces it): each anchor must occur once
EDITS = [
    ("csrc/gmm_wgmma.cuh", "__device__ __forceinline__ void flag_release(unsigned* p) {",
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"
     "__device__ __forceinline__ void flag_release(unsigned* p) {"),
    ("csrc/gmm_wgmma.cuh", "    float4* mine = reinterpret_cast<float4*>(partials) + tid;\n",
     "    float4* mine = reinterpret_cast<float4*>(partials) + tid;\n"
     "    unsigned long long* dbg = reinterpret_cast<unsigned long long*>(\n"
     "        flags + ((gridDim.x + 1) & ~1u)) + blockIdx.x * 64;\n"
     "    int nu = 0;\n"
     "    if (tid == 0) dbg[0] = gtime();\n"),
    ("csrc/gmm_wgmma.cuh",
     "u.k0, u.k1, it);\n      if (u.kind == UNIT_PART) {",
     "u.k0, u.k1, it);\n      if (tid == 0 && nu < 20) dbg[1 + 3 * nu] = gtime();\n"
     "      if (u.kind == UNIT_PART) {"),
    ("csrc/gmm_wgmma.cuh",
     "        if (tid == 0) flag_release(flags + blockIdx.x);\n        continue;",
     "        if (tid == 0) flag_release(flags + blockIdx.x);\n"
     "        if (tid == 0 && nu < 20) dbg[2 + 3 * nu] = dbg[3 + 3 * nu] = gtime();\n"
     "        ++nu;\n        continue;"),
    ("csrc/gmm_wgmma.cuh", "      const int live = live_rows(group_sizes, tl.e, C);\n"
     "      const int row0 = tl.m0 + wg * 64 + r;\n#pragma unroll\n      for (int h = 0;",
     "      if (tid == 0 && nu < 20) dbg[2 + 3 * nu] = gtime();\n"
     "      const int live = live_rows(group_sizes, tl.e, C);\n"
     "      const int row0 = tl.m0 + wg * 64 + r;\n#pragma unroll\n      for (int h = 0;"),
    ("csrc/gmm_wgmma.cuh", "    if (wtid == 0) bulk_wait_group<0>();\n  }\n}",
     "    if (tid == 0) dbg[63] = nu;\n    if (wtid == 0) bulk_wait_group<0>();\n  }\n}"),
    ("csrc/gmm_wgmma.cuh", "          bulk_commit_group();\n        }\n      }\n    }\n",
     "          bulk_commit_group();\n        }\n      }\n"
     "      if (tid == 0 && nu < 20) dbg[3 + 3 * nu] = gtime();\n      ++nu;\n    }\n"),
    ("moe_gmm_bwd.py", "    return grid * (SK_PART_BYTES + 4)",
     f"    return grid * (SK_PART_BYTES + 4) + 8 + grid * {SLOTS} * 8"),
    ("moe_gmm_bwd.py", "    lib = build.library(\"moe_gmm_bwd\", _SIGNATURES)",
     "    moe_gmm_bwd.workspace = ws\n    lib = build.library(\"moe_gmm_bwd\", _SIGNATURES)"),
]


def make_copy() -> None:
    """src/repro_torch with EDITS applied, under COPY/src."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(COPY, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, anchor, text in EDITS:
        path = os.path.join(COPY, "src", "repro_torch", "kernels", name)
        with open(path) as f:
            src = f.read()
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_dx_timeline: {name} no longer holds the anchor\n{anchor}")
        with open(path, "w") as f:
            f.write(src.replace(anchor, text))


def clocks_under(fn, seconds: float = 4.0) -> list:
    """nvidia-smi's SM clock and draw, sampled while fn (built and warm)
    runs in a loop: the samples of the second half."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
            time.sleep(0.05)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    return samples[len(samples) // 2:]


def report(part: str, dbg) -> None:
    import numpy as np

    t0 = dbg[:, 0].min()
    n_units = dbg[:, SLOTS - 1]
    for j in range(int(n_units.max())):
        have = n_units > j
        start = dbg[have, 0] if j == 0 else dbg[have, 3 * j]
        cols = {"products": dbg[have, 1 + 3 * j] - start,
                "wait": dbg[have, 2 + 3 * j] - dbg[have, 1 + 3 * j],
                "epilogue": dbg[have, 3 + 3 * j] - dbg[have, 2 + 3 * j],
                "ended": dbg[have, 3 + 3 * j] - t0}
        stats = " ".join(f"{k} {v.min() / 1e3:.1f}/{np.median(v) / 1e3:.1f}/{v.max() / 1e3:.1f}"
                         for k, v in cols.items())
        print(f"  {part} unit {j}: blocks {int(have.sum())} {stats}")
    ends = [dbg[b, 3 * int(n)] if n else dbg[b, 0] for b, n in enumerate(n_units)]
    print(f"  {part} span {(max(ends) - t0) / 1e3:.1f} us")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    make_copy()
    sys.path.insert(0, os.path.join(COPY, "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import build, moe_gmm_bwd as k4b, ops

    if not torch.cuda.is_available():
        print("torch_dx_timeline: needs a CUDA device", file=sys.stderr)
        return 1
    assert build.CSRC.is_relative_to(COPY), build.CSRC
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed + 22)
    rng = np.random.default_rng(args.seed + 22)
    uniform = np.minimum(rng.multinomial(2048, [1 / 8] * 8), 320)
    gs = torch.tensor(uniform, dtype=torch.int32, device="cuda")
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    for part, (D, F) in (("gate_up", (4096, 14336)), ("down", (14336, 4096))):
        x = torch.randn(8, 320, D, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(8, D, F, generator=g, device="cuda") * D ** -0.5).to(torch.bfloat16)
        dy = torch.randn(8, 320, F, generator=g, device="cuda").to(torch.bfloat16)

        def dx():
            return ops.moe_gmm_bwd(x, w, gs, dy, need_dw=False)

        print(f"{part}: SM clock, draw under a dx loop: {clocks_under(dx)}")
        grid = k4b.dx_grid(8, 320, D, F, build.sm_count(0))
        off = -(-grid * (k4b.SK_PART_BYTES + 4) // 8) * 8
        for rep in range(args.reps):
            flush.sum(dtype=torch.int32)   # L2 holds no line of the operands
            torch.cuda.synchronize()
            dx()
            torch.cuda.synchronize()
            ws = k4b.moe_gmm_bwd.workspace
            dbg = ws[off: off + grid * SLOTS * 8].view(torch.int64).view(grid, SLOTS)
            print(f"{part} rep {rep}:")
            report(part, dbg.cpu().numpy())
        del x, w, dy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
