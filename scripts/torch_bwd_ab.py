"""Time the PyTorch port's backward kernels for trees of this repo on one GPU.

    python3 scripts/torch_bwd_ab.py TREE [TREE ...] [--only SUBSTR ...] [--out FILE] [--seed N]

Runs one process per turn, the trees in the order given and then in reverse
(A, B, B, A for two), so that drift on the card falls on every tree alike.
Each process imports ``repro_torch`` from ``<tree>/src``, builds that tree's
kernels (into ``<tree>/build``) and times, with this repo's
``chip_smoke.py`` (``kernel_times``: CUDA events, median of 10, L2 flushed
before each call by a write, ``ms``, and by a read, ``ms_clean``; each also
as a CUDA-graph replay; ``device_us``: torch.profiler's device time per
kernel after the writing flush):
  - K4's backward at mixtral-8x7b's training gate/up and down (E 8, C 320,
    a uniform router's 2048 rows): both gradients, dx alone, dw alone, and
    ``torch.bmm`` for dx and for dw over all 8 experts;
  - K5's backward at rwkv6-3b's training shape (2, 40, 512, 64), f32;
  - K4's forward at chip_smoke's prefill shapes (E 8, C 640), at mixtral's
    training shapes (C 320, the uniform router's sizes above) and at its
    decode shapes (C 8, sizes 2/0/3/1/0/0/2/0), each beside ``torch.bmm``.
``--only`` keeps the cases whose name holds one of the strings.  Every case
of a port kernel is first checked against its plain version (the error is
recorded, not judged).  One JSON line per turn and case goes to stdout and
to ``--out``; the last lines give each case's readings per tree.  A tree is
a checkout of the repo, for example a ``git archive`` of another commit
unpacked into a directory that ``.gitignore`` lists.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ("ms", "graph_ms", "ms_clean", "graph_ms_clean")


def _cases(seed: int):
    """(name, kernel fn, check fn) of every timed case, inputs on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as k5

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 22)
    rng = np.random.default_rng(seed + 22)
    uniform = np.minimum(rng.multinomial(2048, [1 / 8] * 8), 320)
    gs = torch.tensor(uniform, dtype=torch.int32, device="cuda")
    live = torch.arange(320, device="cuda")[None, :, None] < gs[:, None, None]
    for part, (D, F) in (("gate_up", (4096, 14336)), ("down", (14336, 4096))):
        x = torch.randn(8, 320, D, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(8, D, F, generator=g, device="cuda") * D ** -0.5).to(torch.bfloat16)
        dy = torch.randn(8, 320, F, generator=g, device="cuda").to(torch.bfloat16)
        xz, dyz, wt = torch.where(live, x, 0), torch.where(live, dy, 0), w.transpose(1, 2)

        def check(x=x, w=w, dy=dy):
            want = ref.moe_gmm_bwd_ref(x, w, gs, dy)
            got = ops.moe_gmm_bwd(x, w, gs, dy)
            return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))

        yield (f"moe_gmm_bwd {part}", lambda x=x, w=w, dy=dy: ops.moe_gmm_bwd(x, w, gs, dy),
               check)
        yield (f"moe_gmm_bwd {part} dx", lambda x=x, w=w, dy=dy: ops.moe_gmm_bwd(
            x, w, gs, dy, need_dw=False), None)
        yield (f"moe_gmm_bwd {part} dw", lambda x=x, w=w, dy=dy: ops.moe_gmm_bwd(
            x, w, gs, dy, need_dx=False), None)
        yield f"torch.bmm {part} dx", lambda dyz=dyz, wt=wt: torch.bmm(dyz, wt), None
        yield (f"torch.bmm {part} dw", lambda xz=xz, dy=dy: torch.bmm(xz.transpose(1, 2), dy),
               None)
        del x, w, dy, xz, dyz, wt

    B, H, T, dh = 2, 40, 512, 64
    r, k, v = (torch.randn(B, T, H, dh, generator=g, device="cuda").mul(0.5).transpose(1, 2)
               for _ in range(3))
    wd = torch.sigmoid(torch.randn(B, T, H, dh, generator=g, device="cuda")).transpose(1, 2)
    u = torch.randn(H, dh, generator=g, device="cuda") * 0.3
    s0 = torch.randn(B, H, dh, dh, generator=g, device="cuda") * 0.1
    dout = torch.randn(B, T, H, dh, generator=g, device="cuda").transpose(1, 2)
    ck = torch.empty(k5.checkpoint_shape(B, H, T, dh), device="cuda")
    ops.rwkv6_scan(r, k, v, wd, u, s0, checkpoints=ck)

    def check_k5():
        got = ops.rwkv6_scan_bwd(r, k, v, wd, u, s0, dout, checkpoints=ck)
        want = ref.rwkv6_scan_bwd_ref(r, k, v, wd, u, s0, dout)
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    yield ("rwkv6_scan_bwd (2, 40, 512, 64)",
           lambda: ops.rwkv6_scan_bwd(r, k, v, wd, u, s0, dout, checkpoints=ck), check_k5)

    rng = np.random.default_rng(seed)
    prefill = rng.integers(0, 641, 8)
    prefill[:2] = (0, 640)
    for what, C, sizes in (("prefill", 640, prefill), ("train", 320, uniform),
                           ("decode", 8, np.array([2, 0, 3, 1, 0, 0, 2, 0]))):
        fgs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        flive = torch.arange(C, device="cuda")[None, :, None] < fgs[:, None, None]
        for part, (D, F) in (("gate_up", (4096, 14336)), ("down", (14336, 4096))):
            x = torch.randn(8, C, D, generator=g, device="cuda").to(torch.bfloat16)
            w = (torch.randn(8, D, F, generator=g, device="cuda") * D ** -0.5).to(torch.bfloat16)
            xz = torch.where(flive, x, 0)

            def check_fwd(x=x, w=w, fgs=fgs):
                got, want = ops.moe_gmm(x, w, fgs), ref.moe_gmm_ref(x, w, fgs)
                return float((got.float() - want.float()).abs().max())

            yield (f"moe_gmm {what} {part}", lambda x=x, w=w, fgs=fgs: ops.moe_gmm(x, w, fgs),
                   check_fwd)
            yield f"torch.bmm {what} {part}", lambda xz=xz, w=w: torch.bmm(xz, w), None
            del x, w, xz


def worker(tree: str, turn: int, seed: int, only, out) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke  # noqa: E402  (its timing; it puts this repo's src on sys.path)

    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.kernels import build

    assert build.CSRC.is_relative_to(os.path.abspath(tree)), build.CSRC
    build.build_all(["moe_gmm", "moe_gmm_bwd", "rwkv6_scan", "rwkv6_scan_bwd"])
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, fn, check in _cases(seed):
        if only and not any(o in name for o in only):
            continue
        line = {"tree": tree, "turn": turn, "case": name}
        if check is not None:
            line["max_abs_err"] = check()
        line.update(chip_smoke.kernel_times(fn))
        if check is not None:
            line["device_us"] = chip_smoke.device_us({name: fn})
        print(json.dumps(line), flush=True)
        out.write(json.dumps(line) + "\n")
        out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkouts of the repo, timed in turns")
    ap.add_argument("--only", nargs="*", default=[], help="cases whose name holds one of these")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bwd_ab.jsonl"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=int, metavar="TURN", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        with open(args.out, "a") as out:
            worker(args.trees[0], args.worker, args.seed, args.only, out)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    open(args.out, "w").close()
    for turn, tree in enumerate(args.trees + args.trees[::-1], 1):
        subprocess.run([sys.executable, os.path.abspath(__file__), tree, "--out", args.out,
                        "--seed", str(args.seed), "--worker", str(turn), "--only",
                        *args.only], check=True)
    summary = {}
    for ln in map(json.loads, open(args.out)):
        case = summary.setdefault(ln["case"], {})
        for key in TIMES + ("max_abs_err",):
            if key in ln:
                case.setdefault(ln["tree"], {}).setdefault(key, []).append(ln[key])
    for name, case in summary.items():
        print(json.dumps({"case": name, **case}), flush=True)
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
