"""A configuration of a new kind needs only new files: in a copy of the
benchmark, a made-up kind ``toy`` (its reference, its counts with a kernel
family ``k9``, a reader of that family's roofline), a configuration of that
kind, a mix and a cell are added, and the cell is loaded, served on the
CPU, checked with toy's reference and its ``k9`` roofline read.  Besides,
a configuration without a kind, or of a kind without its files, stops
``load_cell`` with the files it looked for."""

import json
import os
import shutil
import types

import pytest
import torch

from servebench import card, check, devtrace, kinds, readings
from servebench import run as bench_run
from servebench.counts import transformer as transformer_counts
from servebench.serve import Cell
from servebench.tests.test_servebench_faults import MIX, TINY, _Energy

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "toy-tiny.toy_mix"
OFFSET = 1e-3

TOY_REFERENCE = f'''"""A kind made up for a test: the transformer's reference, reading every
position's best logit {OFFSET} higher, so that its use shows in the gaps."""

from servebench.reference import transformer


class Reference(transformer.Reference):
    def run(self, *args, **kwargs):
        out = super().run(*args, **kwargs)
        for o in out:
            o["max"] = o["max"] + {OFFSET}
        return out
'''

TOY_COUNTS = '''"""A kind made up for a test: the transformer's counts and one more
kernel family, k9, that reads 1 GB a layer every step."""

import re

from servebench.counts.transformer import KERNELS as _KERNELS
from servebench.counts.transformer import active_params, step_flops  # noqa: F401
from servebench.counts.transformer import kernel_work as _kernel_work

KERNELS = _KERNELS + (("k9", re.compile(r"::toy_scan_")),)


def kernel_work(m, fmt, step, max_seq):
    return dict(_kernel_work(m, fmt, step, max_seq), k9=(1e9 * m["num_layers"], 0.0))
'''

TOY_READER = '''"""k9's share of its roofline in the traced tail."""

from servebench.readings import roofline


def read(run):
    return roofline(run, "k9")
'''

# device kernel names as the profiler gives them, and the family of each
NAMES = {
    "void (anonymous namespace)::flash_attention_mma_kernel<128, true>(Params)": "k1",
    "void (anonymous namespace)::decode_split_kernel<128>(Params)": "k2",
    "void (anonymous namespace)::int8_wgmma_kernel<2>(CUtensorMap_st, Params)": "k3",
    "void (anonymous namespace)::gmm_decode_kernel(CUtensorMap_st, Params)": "k4",
    "void (anonymous namespace)::gmm_bwd_dx_kernel(CUtensorMap_st, Params)": None,
    "void at::native::vectorized_elementwise_kernel<4, float>(int, float)": None,
}


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "x") as f:
        f.write(text)


@pytest.fixture()
def root(tmp_path):
    """A copy of the benchmark to which only the toy kind's files are added
    (and its entries appended to the copy's BENCHMARK.json)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "servebench"), tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    sb = tmp_path / "servebench"
    _write(str(sb / "reference" / "toy.py"), TOY_REFERENCE)
    _write(str(sb / "counts" / "toy.py"), TOY_COUNTS)
    _write(str(sb / "metrics" / "k9_roofline.py"), TOY_READER)
    with open(os.path.join(ROOT, "servebench", "configs", "minitron-4b.json")) as f:
        config = json.load(f)
    config.update(kind="toy", model=dict(config["model"], **TINY))
    _write(str(sb / "configs" / "toy-tiny.json"), json.dumps(config, indent=1))
    _write(str(sb / "traffic" / "toy_mix.json"), json.dumps(MIX, indent=1))
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-tiny", "source": config["source"],
                             "file": "servebench/configs/toy-tiny.json",
                             "reduced": [], "why": "a made-up kind"})
    bench["workloads"].append({"name": CELL, "config": "toy-tiny", "traffic": "toy_mix",
                               "chips": 1, "why": "a made-up kind's cell"})
    bench["per_layer"].append({"name": "k9_roofline", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "Kernels",
                               "moves": "tokens_per_s", "workloads": [CELL]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f, indent=1)
    return str(tmp_path)


def test_a_new_kind_needs_only_new_files(root):
    spec = bench_run.load_cell(CELL, root)
    config = spec["config"]
    assert spec["cell"]["name"] == CELL and config["kind"] == "toy"
    assert "k9_roofline" in [m["name"] for m in spec["per_layer"]]

    cell = Cell(config, spec["mix"], 2**31 + 5, torch.device("cpu"), root=root)
    assert cell.counts.KERNELS[-1][0] == "k9"
    cell.setup()
    cell.window(0.5, _Energy(), lambda: None, min_done=8)
    cell.free()
    picked = check.sample(cell.finished, 5)
    numbers = check.gaps(config, cell.weights, picked, cell.prompts, torch.device("cpu"), root)
    ok, _ = check.verdict(numbers, config["check"])
    # toy's reference, not the transformer's, read the gaps: each is OFFSET up
    assert ok and numbers["tokens"] > 0
    assert OFFSET * 0.9 < numbers["gap_mean"] and numbers["gap_max"] < OFFSET * 2

    for name, fam in NAMES.items():
        assert devtrace.family(name, cell.counts.KERNELS) == fam, name
        assert devtrace.family(name, transformer_counts.KERNELS) == fam, name
    toy_kernel = "void (anonymous namespace)::toy_scan_kernel<64>(float const*, float*)"
    assert devtrace.family(toy_kernel, cell.counts.KERNELS) == "k9"
    assert devtrace.family(toy_kernel, transformer_counts.KERNELS) is None

    steps = [{"kind": "decode", "lens": [3, 9, 0, 0], "live_ctx": [4, 10]}] * 4
    peaks = card.PEAKS["NVIDIA H100 80GB HBM3"]
    traced = types.SimpleNamespace(
        device_trace={"kernel_s": {"k9": 0.5, "k2": 1e-3}}, peaks=peaks,
        traced=types.SimpleNamespace(steps=steps), counts=cell.counts,
        model=config["model"], fmt=config["format"], max_seq=MIX["max_seq"])
    want = 100.0 * 4 * 1e9 * TINY["num_layers"] / peaks["hbm_bytes_s"] / 0.5
    assert readings.roofline(traced, "k9") == pytest.approx(want, rel=1e-12)
    assert bench_run.reader("k9_roofline", root)(traced) == pytest.approx(want, rel=1e-12)
    # the transformer's families read as the transformer's counts have them
    assert readings.roofline(traced, "k2") == pytest.approx(readings.roofline(
        types.SimpleNamespace(**dict(vars(traced), counts=transformer_counts)), "k2"))


@pytest.mark.parametrize("kind", [None, "nonesuch", "../configs/minitron-4b"])
def test_a_config_without_its_kind_stops_load_cell(root, kind):
    path = os.path.join(root, "servebench", "configs", "toy-tiny.json")
    with open(path) as f:
        config = json.load(f)
    if kind is None:
        del config["kind"]
    else:
        config["kind"] = kind
    with open(path, "w") as f:
        json.dump(config, f)
    with pytest.raises(SystemExit, match="servebench/reference/") as err:
        bench_run.load_cell(CELL, root)
    assert "servebench/counts/" in str(err.value) and CELL in str(err.value)


def test_the_transformer_kind_is_found_by_its_files():
    from servebench.reference import transformer

    config = {"kind": "transformer"}
    assert kinds.counts(config).KERNELS == transformer_counts.KERNELS
    assert kinds.reference(config).MATMUL == transformer.Reference.MATMUL
    assert kinds.paths(config) == {
        part: os.path.join(ROOT, "servebench", part, "transformer.py")
        for part in ("reference", "counts")}
