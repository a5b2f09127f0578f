"""Operations and bytes the rooflines and mfu are counted from: the
``transformer`` kind's counts (``servebench/counts/transformer.py``)."""

import json
import os

import pytest

from servebench.counts import transformer as work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def model(name):
    with open(os.path.join(ROOT, "servebench", "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


def test_active_parameters_of_the_configurations():
    layers, head = work.active_params(model("minitron-4b"))
    assert (layers + head) / 1e9 == pytest.approx(3.41, abs=0.01)
    layers, head = work.active_params(model("mixtral-8x7b"))
    assert layers / 1e9 == pytest.approx(24 * 0.394, rel=0.01)
    assert head == 4096 * 32000


def test_prefill_k1_counts_causal_pairs_and_k4_every_expert():
    m = model("mixtral-8x7b")
    w = work.kernel_work(m, "rsm", {"kind": "prefill", "bucket": 256}, 1280)
    pairs = 256 * 257 // 2
    assert w["k1"][1] == 24 * 4.0 * 32 * 128 * pairs
    assert w["k1"][0] == 24 * 2 * (2 * 256 * 32 * 128 + 2 * 256 * 8 * 128)
    assert w["k4"][0] == pytest.approx(24 * 3 * 2 * (8 * 4096 * 14336 + 512 * (4096 + 14336)))
    assert "k2" not in w and "k3" not in w


def test_decode_k2_reads_every_slot_up_to_max_seq_and_k3_its_weights():
    m = model("minitron-4b")
    step = {"kind": "decode", "lens": [0, 99, 2559, 5000], "live_ctx": [50]}
    w = work.kernel_work(m, "rsm_int8", step, 2560)
    entries = 1 + 100 + 2560 + 2560
    assert w["k2"][1] == 32 * 4.0 * 24 * 128 * entries
    weights = sum(d * n + 4 * n for d, n in work.dense_shapes(m))
    rows = sum(2 * 4 * (d + n) for d, n in work.dense_shapes(m))
    assert w["k3"][0] == 32 * (weights + rows)
    assert "k1" not in work.kernel_work(m, "rsm", step, 2560)


def test_step_flops_count_real_tokens_only():
    m = model("minitron-4b")
    layers, head = work.active_params(m)
    pre = work.step_flops(m, {"kind": "prefill", "prompt": 100, "bucket": 128})
    assert pre == 2 * layers * 100 + 4.0 * 32 * 24 * 128 * 5050 + 2 * head
    dec = work.step_flops(m, {"kind": "decode", "lens": [0] * 64, "live_ctx": [10, 20]})
    assert dec == 2 * 2 * (layers + head) + 4.0 * 32 * 24 * 128 * 30


def test_window_caps_pairs():
    assert work._pairs(10, None) == 55
    assert work._pairs(10, 4) == 10 + 6 * 4


# Golden values of the three configurations at full width: the numbers the
# cells' rooflines and mfu have been read from since the cells were first
# measured, so that a change to the counts shows here.  A prefill of bucket
# 1024 (700 real tokens) and a decode step of 32 slots at lengths 100-1280,
# with a 1280-entry cache.
LENS = [100 + 1180 * i // 31 for i in range(32)]
PREFILL = {"kind": "prefill", "bucket": 1024, "prompt": 700}
DECODE = {"kind": "decode", "lens": LENS, "live_ctx": [n + 1 for n in LENS]}
GOLDEN = {
    "minitron-4b": {
        "prefill": {"k1": (536870912.0, 206359756800.0)},
        "decode": {"k2": (2908749824.0, 8688500736.0)},
        "flops": (3762192384000.0, 226524266496.0),
        "active": (2617245696.0, 786432000.0)},
    "minitron-4b-int8": {
        "prefill": {"k1": (536870912.0, 206359756800.0),
                    "k3": (5572657152.0, 5360119185408.0)},
        "decode": {"k2": (2908749824.0, 8688500736.0),
                   "k3": (2712141824.0, 167503724544.0)},
        "flops": (3762192384000.0, 226524266496.0),
        "active": (2617245696.0, 786432000.0)},
    "mixtral-8x7b": {
        "prefill": {"k1": (503316480.0, 206359756800.0),
                    "k4": (73081552896.0, 17317308137472.0)},
        "decode": {"k2": (2184708096.0, 8688500736.0),
                   "k4": (67815604224.0, 541165879296.0)},
        "flops": (13345128448000.0, 622718222336.0),
        "active": (9463136256.0, 131072000.0)},
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_counts_equal_their_golden_values(name):
    with open(os.path.join(ROOT, "servebench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    m, fmt, want = cfg["model"], cfg["format"], GOLDEN[name]
    assert work.kernel_work(m, fmt, PREFILL, 1280) == want["prefill"]
    assert work.kernel_work(m, fmt, DECODE, 1280) == want["decode"]
    assert (work.step_flops(m, PREFILL), work.step_flops(m, DECODE)) == want["flops"]
    assert work.active_params(m) == want["active"]
