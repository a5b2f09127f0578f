"""TD2 formats: files written by either package load in the other, the port
writes the JAX package's bytes, and the norm-gain fence lets rsm_int8 serve
models of 8 or more layers."""

import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.serving import formats as jfmt
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.serving import formats as tfmt


def _twins(layers=2, dtype=None):
    jcfg = dataclasses.replace(j_get_arch("minitron-4b-smoke"), num_layers=layers)
    cfg = dataclasses.replace(get_arch("minitron-4b-smoke"), num_layers=layers)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        p = jax.tree.map(lambda t: t.to(torch.bfloat16), p)
    return jcfg, cfg, jp, p


def _flat_np(tree):
    """{key: array or (wq, scales)} of either package's tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "wq"))[0]:
        key = jax.tree_util.keystr(path)
        if hasattr(leaf, "wq"):
            out[key] = tuple(_np(a) for a in (leaf.wq, leaf.scales))
        else:
            out[key] = _np(leaf)
    return out


def _np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.float().numpy().astype(jnp.bfloat16)
        return a.numpy()
    return np.asarray(a)


def _assert_same(a, b):
    fa, fb = _flat_np(a), _flat_np(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (fa[k], fb[k]))):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _save(mod, params, fmt, path):
    if fmt == "native":
        mod.save_native(params, path)
    else:
        mod.save_rsm(params, path, quantize=fmt == "rsm_int8")


def _load_j(template, fmt, path):
    if fmt == "native":
        return jfmt.load_native(template, path)
    return jfmt.load_rsm(template, path, as_qtensor=fmt == "rsm_int8")


def _load_t(template, fmt, path):
    if fmt == "native":
        return tfmt.load_native(template, path, device="cpu")
    return tfmt.load_rsm(template, path, as_qtensor=fmt == "rsm_int8", device="cpu")


FORMATS = ["native", "rsm", "rsm_int8"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_cross_package_load(fmt, tmp_path):
    _, _, jp, p = _twins()
    jdir, tdir = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    if fmt != "native":
        jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _save(jfmt, jp, fmt, jdir)
    _save(tfmt, p, fmt, tdir)
    want = _load_j(jp, fmt, jdir)
    _assert_same(_load_t(p, fmt, jdir), want)      # JAX wrote, port reads
    _assert_same(_load_j(jp, fmt, tdir), want)     # port wrote, JAX reads
    _assert_same(_load_t(p, fmt, tdir), want)


@pytest.mark.parametrize("fmt", ["rsm", "rsm_int8"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_port_writes_identical_bytes(fmt, dtype, tmp_path):
    _, _, jp, p = _twins(dtype=dtype)
    _save(jfmt, jp, fmt, str(tmp_path / "j"))
    _save(tfmt, p, fmt, str(tmp_path / "t"))
    for name in ("manifest.json", "tensors.bin"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    if dtype:
        manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
        assert manifest["tensors"]["embed"]["orig_dtype"] == "bfloat16"
        assert manifest["tensors"]["embed"]["dtype"] == "float32"


def test_native_npz_members_identical(tmp_path):
    _, _, jp, p = _twins(dtype="bfloat16")
    jfmt.save_native(jp, str(tmp_path / "j.npz"))
    tfmt.save_native(p, str(tmp_path / "t.npz"))
    with zipfile.ZipFile(tmp_path / "j.npz") as zj, zipfile.ZipFile(tmp_path / "t.npz") as zt:
        assert zj.namelist() == zt.namelist()
        for n in zj.namelist():   # zip timestamps aside, the bytes are the same
            assert zj.read(n) == zt.read(n), n


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_size_bytes_equal(fmt, tmp_path):
    _, _, jp, p = _twins()
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    assert tfmt.format_size_bytes(p, fmt, str(tmp_path / "t")) == \
        jfmt.format_size_bytes(jp, fmt, str(tmp_path / "j"))


def test_fence_serves_eight_layer_rsm_int8(tmp_path):
    """The JAX package quantizes the stacked norm gains at L >= 8 and its
    QTensor path then fails; the port dequantizes them and serves."""
    jcfg, cfg, jp, p = _twins(layers=8)
    path = str(tmp_path / "rsm8")
    jfmt.save_rsm(jp, path, quantize=True)
    manifest = json.loads((tmp_path / "rsm8" / "manifest.json").read_text())
    assert manifest["tensors"]["layers/ln1"]["quantized"]

    served = tfmt.load_rsm(p, path, as_qtensor=True, device="cpu")
    assert isinstance(served["layers"]["ln1"], torch.Tensor)
    assert served["layers"]["ln1"].dtype == torch.float32
    assert isinstance(served["layers"]["attn"]["wq"], tfmt.QTensor)
    assert isinstance(served["layers"]["mlp"]["wo"], tfmt.QTensor)

    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want = JT.forward(jfmt.load_rsm(jp, path, as_qtensor=False), jcfg,
                      {"tokens": jnp.asarray(toks)})["logits"]
    got = T.forward(served, cfg, {"tokens": torch.from_numpy(toks)})["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        JT.forward(jfmt.load_rsm(jp, path, as_qtensor=True), jcfg,
                   {"tokens": jnp.asarray(toks)})


def test_quantize_params_equals_disk_round_trip(tmp_path):
    _, _, _, p = _twins(layers=8)
    tfmt.save_rsm(p, str(tmp_path / "q"), quantize=True)
    loaded = tfmt.load_rsm(p, str(tmp_path / "q"), as_qtensor=True, device="cpu")
    _assert_same(tfmt.quantize_params(p), loaded)
