"""The port's sharding policy, fake-tensor specs and ambient constraints
against the JAX package's, on the CPU.

The reference's policy functions read only a mesh's ``shape`` and
``axis_names``, and the port's only ``shape`` and ``mesh_dim_names``, so
small stand-in meshes serve both: no process group, no device.  Every leaf
of every tree is held to the reference's PartitionSpec exactly; the port's
placements are checked against an independent reading of those specs.
Shapes come from the port's ``param_specs`` (no allocation); the structs
are held to the reference's ``jax.eval_shape`` structs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_variant as j_smoke_variant
from repro.distributed import ctx as jctx
from repro.distributed import meshes as JM
from repro.launch import specs as jspecs
from repro.models import init_params as j_init_params
from repro.training import optim as joptim
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distributed import ctx
from repro_torch.distributed import meshes as M
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.training import optim as toptim

ARCH_NAMES = sorted(J_ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class _RefMesh:
    """What the reference's policy reads of a jax Mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


class _PortMesh:
    """What the port's policy reads of a DeviceMesh."""

    def __init__(self, shape, names):
        self.shape = shape
        self.mesh_dim_names = names
        self.ndim = len(shape)


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return _Leaf(tree.shape)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _flat_ref(tree):
    """The reference's spec tree (PartitionSpec leaves) as {path: entries}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(spec)
            for path, spec in leaves}


def _independent_placements(names, entries):
    """A PartitionSpec's DTensor placements, read without the port's code."""
    out = []
    for name in names:
        dims = [d for d, e in enumerate(entries)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _check(port_entries, port_placements, ref_specs, names):
    ref = _flat_ref(ref_specs)
    got = _flat(port_entries)
    assert set(got) == set(ref)
    for path, entries in ref.items():
        assert got[path] == entries, (path, got[path], entries)
        assert _flat(port_placements)[path] == _independent_placements(names, entries), path
    return len(ref)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shardings_equal_reference_leaf_for_leaf(arch):
    cfg = get_arch(arch)
    jcfg = j_get_arch(arch)
    p_shape = _shapes(T.param_specs(cfg))
    n = 0
    for mesh_name, (shape, names) in MESHES.items():
        rm, pm = _RefMesh(shape, names), _PortMesh(shape, names)
        for mode in ("train", "serve"):
            n += _check(M.param_specs(p_shape, pm, mode), M.param_shardings(p_shape, pm, mode),
                        JM.param_shardings(p_shape, rm, mode), names)
        opt = {"m": p_shape, "v": p_shape, "step": _Leaf(())}
        n += _check(M.opt_specs(opt, pm), M.opt_shardings(opt, pm),
                    JM.opt_shardings(opt, rm), names)
        for sname, sh in SHAPES.items():
            if not j_applicable(jcfg, J_SHAPES[sname]):
                continue
            batch = _shapes(jspecs.batch_struct(jcfg, J_SHAPES[sname],
                                                with_labels=sh.kind == "train"))
            n += _check(M.batch_specs(batch, pm), M.batch_shardings(batch, pm),
                        JM.batch_shardings(batch, rm), names)
            if sh.kind == "decode":
                cache = _shapes(jspecs.cache_struct(jcfg, sh.global_batch, sh.seq_len))
                n += _check(M.cache_specs(cache, pm, cfg), M.cache_shardings(cache, pm, cfg),
                            JM.cache_shardings(cache, rm, jcfg), names)
    assert n > 50


def test_placements_of_multi_axis_entries():
    names = ("pod", "data", "model")
    pm = _PortMesh((2, 16, 16), names)
    # a ('pod', 'data') entry shards one tensor dim over both mesh dims
    assert ctx.placements(pm, (("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
    # the long-context cache: the sequence over all three
    assert ctx.placements(pm, (None, None, ("pod", "data", "model"), None, None)) == (
        Shard(2), Shard(2), Shard(2))
    assert ctx.placements(pm, ()) == (Replicate(),) * 3
    assert ctx.placements(pm, (None, "model")) == (Replicate(), Replicate(), Shard(1))


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_structs_equal_reference_shapes_and_dtypes(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    mode = FakeTensorMode()

    def same(port, ref):
        fp = _flat(port)
        fr = {"/".join(str(getattr(k, "key", k)) for k in path): (tuple(x.shape), str(x.dtype))
              for path, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert set(fp) == set(fr)
        for k, t in fp.items():
            assert (tuple(t.shape), _dtype(t.dtype)) == fr[k], k

    same(specs.params_struct(cfg, mode), jspecs.params_struct(jcfg))
    port_opt = specs.opt_struct(cfg, mode)
    ref_opt = jspecs.opt_struct(jcfg)
    assert port_opt["step"] == 0 and ref_opt["step"].shape == ()
    same({"m": port_opt["m"], "v": port_opt["v"]}, {"m": ref_opt["m"], "v": ref_opt["v"]})
    for sname, sh in SHAPES.items():
        jsh = J_SHAPES[sname]
        if not j_applicable(jcfg, jsh):
            continue
        for labels in (True, False):
            same(specs.batch_struct(cfg, sh, with_labels=labels, mode=mode),
                 jspecs.batch_struct(jcfg, jsh, with_labels=labels))
        if sh.kind == "decode":
            same(specs.cache_struct(cfg, sh.global_batch, sh.seq_len, mode),
                 jspecs.cache_struct(jcfg, jsh.global_batch, jsh.seq_len))
        if sh.kind == "train":
            for dp in (1, 16, 32):
                assert specs.microbatches_for(cfg, sh, dp) == jspecs.microbatches_for(
                    jcfg, jsh, dp)


def test_structs_hold_no_memory():
    mode = FakeTensorMode()
    p = specs.params_struct(get_arch("arctic-480b"), mode)
    leaf = p["layers"]["moe_block"]["moe"]["wi_gate"]
    assert tuple(leaf.shape) == (35, 128, 7168, 4864)
    assert type(leaf).__name__ == "FakeTensor"


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(4, 8, 16)
    assert ctx.constrain(x, ("dp", None, None)) is x
    with ctx.sharding_hints(None):
        assert ctx.constrain(x, ("dp", None, None)) is x
    pm = _PortMesh((16, 16), ("data", "model"))
    with ctx.sharding_hints(pm, roles=()):
        assert ctx.constrain(x, ("dp", None, None)) is x
    with ctx.sharding_hints(pm, roles=("residual",)):
        # a plain tensor (a model on one card) passes as it is
        assert ctx.constrain(x, ("dp", None, None)) is x
    assert ctx._HINTS["mesh"] is None


CONSTRAIN_CASES = [((256, 4096, 3072), ("dp", None, None), "residual"),
                   ((7, 4096, 3072), ("dp", None, None), "residual"),
                   ((32, 1, 64), ("dp", None, None), "residual"),
                   ((8, 40960, 4096), (None, "dp", None), "moe"),
                   ((8, 40, 4096), (None, "dp", None), "moe"),
                   ((64, 2048), ("model", None), "residual")]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_constrain_chooses_the_reference_entries(monkeypatch, mesh_name):
    shape, names = MESHES[mesh_name]
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: seen.append(sharding) or x)
    monkeypatch.setattr(jctx, "NamedSharding", lambda mesh, spec: tuple(spec))
    rm, pm = _RefMesh(shape, names), _PortMesh(shape, names)
    for tshape, template, role in CONSTRAIN_CASES:
        with jctx.sharding_hints(rm, roles=(role,)):
            jctx.constrain(jax.ShapeDtypeStruct(tshape, jnp.float32), template, role)
        assert ctx.entries(pm, tshape, template) == seen[-1], (tshape, template)
    assert len(seen) == len(CONSTRAIN_CASES)


def test_init_opt_state_bf16_and_adamw_match_reference():
    """bf16 m and v (the dry-run's optimizer state): zeros of the parameters'
    shapes, and one AdamW step on the same gradients gives the reference's
    parameters at 1e-6 and its bf16 m and v to one bf16 rounding."""
    jcfg = j_smoke_variant(j_get_arch("minitron-4b"))
    cfg = get_arch(jcfg.name)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      j_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jg = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32), jp)
    params = T.params_from_numpy(jp, cfg, device="cpu")
    grads = T.params_from_numpy(jg, cfg, device="cpu")
    state = toptim.init_opt_state(params, dtype=torch.bfloat16)
    for leaf, p in zip(toptim.tree_leaves(state["m"]), toptim.tree_leaves(params)):
        assert leaf.dtype == torch.bfloat16 and leaf.shape == p.shape and not leaf.any()
    assert toptim.init_opt_state(params)["m"]["embed"].dtype == torch.float32
    jstate = joptim.init_opt_state(jax.tree.map(jnp.asarray, jp), dtype=jnp.bfloat16)
    ocfg = toptim.AdamWConfig(warmup_steps=1, total_steps=10)
    jcfg_opt = joptim.AdamWConfig(warmup_steps=1, total_steps=10)
    for _ in range(2):
        params, state, _ = toptim.adamw_update(ocfg, params, grads, state)
        jp, jstate, _ = joptim.adamw_update(jcfg_opt, jax.tree.map(jnp.asarray, jp),
                                            jax.tree.map(jnp.asarray, jg), jstate)
    flat_p = _flat(params)
    ref_p = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, a in ref_p:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_allclose(flat_p[key].numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)
    for which in ("m", "v"):
        got = _flat(state[which])
        for path, a in jax.tree_util.tree_flatten_with_path(jstate[which])[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            assert got[key].dtype == torch.bfloat16
            np.testing.assert_allclose(got[key].float().numpy(),
                                       np.asarray(a.astype(jnp.float32)),
                                       rtol=2 ** -7, atol=1e-30)
    assert state["step"] == 2
