"""A run of the harness on the CPU at a size a test run holds, sound and
with the timed path broken underneath: ``correct`` must come out true for
the sound run and false for each fault a served cell can have (one chip:
no exchange between chips to leave out).  The control's readings at the
cells' own sizes are taken on the card (``test_control_fails_at_cell_size``).
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from servebench import check
from servebench.serve import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MIX = {"loop": "open", "rate_per_s": 40.0, "prompt": [5, 40], "output": [3, 12],
       "slots": 4, "max_seq": 80, "warm_in_s": 0.05}
TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 512, "dtype": "float32"}


class _Energy:
    def start(self):
        self.t = time.perf_counter()

    def read(self):
        return time.perf_counter() - self.t


def _config(name):
    with open(os.path.join(ROOT, "servebench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["model"] = dict(cfg["model"], **TINY)
    return cfg


def _served(name, fault=None, seconds=0.5, loop="open"):
    cfg = _config(name)
    cell = Cell(cfg, dict(MIX, loop=loop), 2**31 + 77, torch.device("cpu"))
    cell.setup()
    if fault is not None:
        fault(cell.engine)
    cell.window(seconds, _Energy(), lambda: None, min_done=8)
    cell.free()
    picked = check.sample(cell.finished, 5)
    numbers = check.gaps(cfg, cell.weights, picked, cell.prompts, torch.device("cpu"))
    return check.verdict(numbers, cfg["check"])[0], numbers


def _token_altered(engine):
    decode = engine.decode_batch

    def altered(cache, tokens):
        logits, cache = decode(cache, tokens)
        wrong = (logits.argmax(-1) + 1) % logits.shape[1]
        return logits.scatter_add(1, wrong[:, None], torch.full_like(logits[:, :1], 1e3)), cache
    engine.decode_batch = altered


def _state_unchanged(engine):
    decode = engine.decode_batch

    def unchanged(cache, tokens):
        kept = {k: v.clone() for k, v in cache.items()}
        logits, new = decode(cache, tokens)
        return logits, kept
    engine.decode_batch = unchanged


def _half_batch(engine):
    decode = engine.decode_batch
    stale = {}

    def half(cache, tokens):
        logits, cache = decode(cache, tokens)
        B = logits.shape[0]
        out = logits.clone()
        if "last" in stale:
            out[B // 2:] = stale["last"][B // 2:]
        stale["last"] = logits.clone()
        return out, cache
    engine.decode_batch = half


@pytest.mark.parametrize("name", ["minitron-4b", "minitron-4b-int8", "mixtral-8x7b"])
def test_sound_run_is_correct(name):
    ok, numbers = _served(name)
    assert ok and numbers["tokens"] > 0 and numbers["gap_max"] < 1e-3


def _one_slot_altered(engine):
    decode = engine.decode_batch

    def altered(cache, tokens):
        logits, cache = decode(cache, tokens)
        wrong = (logits[0].argmax() + 1) % logits.shape[1]
        out = logits.clone()
        out[0, wrong] += 1e3
        return out, cache
    engine.decode_batch = altered


@pytest.mark.parametrize("name", ["minitron-4b", "mixtral-8x7b"])
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch,
                                   _one_slot_altered],
                         ids=["token_altered", "state_unchanged", "half_batch",
                              "one_slot_altered"])
def test_fault_is_not_correct(fault, name):
    """The cells' backlog, with the fault planted under the harness."""
    ok, numbers = _served(name, fault, loop="backlog")
    assert not ok, numbers


def test_backlog_run_is_correct():
    ok, numbers = _served("minitron-4b", loop="backlog")
    assert ok and numbers["tokens"] > 0


def test_control_reads_above_the_sound_program():
    cfg = _config("minitron-4b")
    cell = Cell(cfg, MIX, 5, torch.device("cpu"))
    cell.setup()
    cell.window(1.0, _Energy(), lambda: None, min_done=8)
    cell.free()
    picked = check.sample(cell.finished, 5)
    sound = check.gaps(cfg, cell.weights, picked, cell.prompts, torch.device("cpu"))
    low = check.control_gaps(cfg, cell.weights, picked, cell.prompts, torch.device("cpu"))
    assert low["gap_max"] > sound["gap_max"] and low["tokens"] == sound["tokens"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mixtral-8x7b.chat", "minitron-4b.decode",
                                  "minitron-4b-int8.decode", "minitron-4b.prompt"])
def test_control_fails_at_cell_size(cell):
    """On the card: with the control precision in the program's place on the
    sample of a short run of the cell at its own size, the run's own verdict
    is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "servebench", "run.py"),
                          "--workload", cell, "--seed", "1234567", "--seconds", "20",
                          "--trace", "0", "--control"], capture_output=True, text=True,
                         cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] is False, (result["check"], out.stderr[-2000:])
    assert any(v["value"] > v["limit"] for v in result["check"].values()), result["check"]
