"""DTensor rules the dry-run adds where DTensor has none that fits.

DTensor propagates placements op by op and raises where it has no strategy,
where an in-place op would need its operand moved, or where a view cannot
unflatten a dim sharded unevenly; elsewhere its greedy choice can hold a
whole tensor on every rank.  GSPMD, which the JAX package's dry-run relies
on, shards through all of these.  The rules here, each for an op of the
port's models, keep what GSPMD keeps:

  * ``register``: ``view`` and ``_unsafe_view`` may redistribute an input
    they cannot view in place (24 heads unflattened from a dim of 3072
    sharded 16 ways), as DTensor's ``reshape`` already may; ``mm.dtype``
    (the bf16 unembedding with float32 logits, ``models/layers.py``) gets
    ``mm``'s strategies for rows and columns, not the contraction's
    Partial, whose float32 (tokens, vocab) sums each rank would hold whole.
  * ``GspmdLike``, a dispatch mode, runs these ops itself:
      - ``index.Tensor`` (an embedding lookup, the decode cache's old
        entries, the windowed gather): a masked gather, so a dim it reads
        that is sharded gives a sum over the ranks (all-reduced at once);
        the index keeps its batch shard;
      - ``index_put_`` (the decode cache write): each rank writes the
        entries it holds; the cache keeps its shards;
      - ``index_add_`` (the moe dispatch): in place, the other operands
        gathered;
      - ``gather`` and ``scatter_add(_)`` along a sharded dim (the loss's
        label pick over a vocabulary-sharded log-softmax, and its
        gradient): masked, as ``index``;
      - ``_log_softmax`` and its backward along a sharded dim: the row max
        and row sum all-reduced, the result sharded as its input;
      - ``new_zeros``/``new_empty``: a dim equal to the operand's keeps its
        shard;
      - ``flip``: the dims it does not reverse keep their shards (torch
        2.11's DTensor has no rule for it);
      - ``view`` of an unevenly sharded tensor gathered back (a narrowed,
        padded buffer): made contiguous first.
    Any other op goes through DTensor's own rule, and where that raises,
    runs on gathered operands with Replicate outputs (an in-place op keeps
    its target's shards); ``fallbacks`` counts such ops.  Every gather and
    sum these imply is issued as a collective, so the tracer counts it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

aten = torch.ops.aten


def register() -> None:
    """Register the view and mm.dtype rules and clear DTensor's caches; the
    dry-run calls it before each trace (idempotent; DTensor's registry is
    process-wide, and the port uses DTensor only in the dry-run)."""
    from torch.distributed.tensor import _ops  # noqa: F401 (registers the defaults)
    from torch.distributed.tensor.experimental import register_sharding
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops._view_ops import register_op_strategy_map

    for op in (aten.view.default, aten._unsafe_view.default):
        register_op_strategy_map(op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1),
                                 strict_view=False)

    @register_sharding(aten.mm.dtype)
    def _mm_dtype(x, w, out_dtype):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None])]

    # DTensor caches its choices by op and placements, and a cached choice
    # holds its mesh: after a new process group (``launch/mesh.py``) a mesh
    # of the same shape would find the old one's groups
    try:
        from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    except ImportError:   # a torch without the fast path's cache
        _clear_sharding_prop_cache = \
            DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear
    _clear_sharding_prop_cache()


@contextlib.contextmanager
def unseen_meta(trace):
    """Pause ``trace`` while DTensor works out an op's output shape: it runs
    the op once on global-shaped fake tensors, which no rank allocates or
    computes (and caches the answer, so counting it would depend on what
    ran before)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, op_schema):
        trace.paused += 1
        try:
            return orig(self, op_schema)
        finally:
            trace.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _replicate(t):
    if not isinstance(t, DTensor):
        return t
    if any(not p.is_replicate() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t.to_local()


def _to(t, placements):
    """The local tensor of DTensor ``t`` moved to ``placements``."""
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(t.device_mesh, placements)
    return t.to_local()


def summed(t):
    """A Partial DTensor summed over its mesh dims at once (an all-reduce),
    as GSPMD sums a masked gather or a split contraction where it ends: a
    pending Partial meets ops DTensor cannot move it through (torch 2.11
    has no Shard-to-Partial move)."""
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def _flip(x, dims):
    """``flip`` keeps the shards of the dims it does not reverse (torch 2.11's
    DTensor has no rule for it)."""
    if not isinstance(x, DTensor):
        return None
    rev = {d % x.ndim for d in dims}
    pl = [Replicate() if p.is_shard() and p.dim in rev or p.is_partial() else p
          for p in x.placements]
    local = aten.flip.default(_to(x, pl), dims)
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def _view(x, *args, **kwargs):
    """A view of a DTensor whose local shard is not contiguous (an uneven
    shard gathered back is a narrowed, padded buffer), made contiguous
    first: the global tensor the model views is contiguous."""
    local = x.to_local() if isinstance(x, DTensor) else None
    if local is None or local.is_contiguous():
        return None
    x = DTensor.from_local(local.contiguous(), x.device_mesh, x.placements, run_check=False,
                           shape=x.shape, stride=x.stride())
    return aten.view.default(x, *args, **kwargs)


def _indexed(indices):
    """(first indexed dim, count, the index tensors) of an advanced index
    whose index tensors sit on consecutive dims, else None."""
    dims = [d for d, ix in enumerate(indices) if ix is not None]
    if not dims or dims != list(range(dims[0], dims[-1] + 1)):
        return None
    return dims[0], len(dims), [indices[d] for d in dims]


def _gathered_into(func, target, *args, **kwargs):
    """An in-place ``func`` on ``target``'s local shard (or on ``target``
    itself, a tensor the model made whole), every other operand gathered."""
    rest, rest_kw = tree_map(_replicate, (args, kwargs))
    func(target.to_local() if isinstance(target, DTensor) else target, *rest, **rest_kw)
    return target


def _index(self_t, indices):
    """``self_t[indices]`` as GSPMD gathers: a dim the index reads that is
    sharded gives a Partial output (each shard gathers the entries it holds,
    the rest are zero: a masked gather); other sharded dims stay sharded;
    index tensors keep a shard they all share on a mesh dim self does not
    shard, and are gathered on any other."""
    found = _indexed(indices)
    if found is None or not isinstance(self_t, DTensor):
        return None
    d0, n, ixs = found
    mesh = self_t.device_mesh
    nd = max(ix.ndim for ix in ixs)
    out_pl, ix_pl = [], []
    for m, p in enumerate(self_t.placements):
        ix_p = Replicate()
        if p.is_shard():
            j = p.dim
            out_pl.append(Partial() if d0 <= j < d0 + n
                          else Shard(j if j < d0 else j - n + nd))
        elif p.is_partial():
            out_pl.append(p)
        else:
            shared = {ix.placements[m] if isinstance(ix, DTensor) else Replicate()
                      for ix in ixs}
            q = shared.pop() if len(shared) == 1 else Replicate()
            if q.is_shard() and all(ix.ndim == nd for ix in ixs):
                ix_p = q
                out_pl.append(Shard(d0 + q.dim))
            else:
                out_pl.append(Replicate())
        ix_pl.append(ix_p)
    local_ix = [None if ix is None else
                (_to(ix, ix_pl) if isinstance(ix, DTensor) else ix) for ix in indices]
    out = torch.ops.aten.index.Tensor(self_t.to_local(), local_ix)
    return summed(DTensor.from_local(out, mesh, out_pl, run_check=False))


def _index_put(self_t, indices, values, accumulate=False):
    """``self_t[indices] = values`` in place, as GSPMD scatters: self keeps
    its shards; values stay sharded along a sharded dim of self the index
    does not touch and are gathered on every other mesh dim, as are the
    index tensors (each shard writes the entries it holds)."""
    found = _indexed(indices)
    if found is None or not isinstance(self_t, DTensor):
        return _gathered_into(aten.index_put_.default, self_t, indices, values, accumulate)
    d0, n, ixs = found
    nd = max(ix.ndim for ix in ixs)
    v_pl = []
    for p in self_t.placements:
        if p.is_shard() and not d0 <= p.dim < d0 + n:
            j = p.dim if p.dim < d0 else p.dim - n + nd
            # values broadcast against the indexed shape from the right
            v_pl.append(Shard(j - (self_t.ndim - n + nd - values.ndim)))
        else:
            v_pl.append(Replicate())
    vals = _to(values, v_pl) if isinstance(values, DTensor) else values
    local_ix = [None if ix is None else _replicate(ix) for ix in indices]
    torch.ops.aten.index_put_.default(self_t.to_local(), local_ix, vals, accumulate)
    return self_t


class GspmdLike(TorchDispatchMode):
    """Runs the ops of ``_RULES`` by the rules here, any other op through
    DTensor's own rule, and on gathered operands where DTensor has none
    that fits (see the module docstring); ``fallbacks`` counts those by op.
    Enter it above the tracer, so that the local ops of every path reach
    the tracer."""

    fallbacks: dict

    def __init__(self):
        super().__init__()
        self.fallbacks = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _RULES:
            out = _RULES[func](*args, **kwargs)
            if out is not None:
                return out
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, AssertionError):
            pass    # no DTensor rule fits: gather, as GSPMD does
        name = str(func)
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        if func._schema.is_mutable:
            return _gathered_into(func, *args, **kwargs)
        mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        local_args, local_kwargs = tree_map(_replicate, (args, kwargs))
        out = func(*local_args, **local_kwargs)
        return tree_map(lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)


def _sharded_on(t, dim) -> bool:
    return isinstance(t, DTensor) and any(p.is_shard(dim % t.ndim) for p in t.placements)


def _log_softmax(x, dim, half_to_float=False):
    """Along a sharded dim, as GSPMD does: the row max and the row sum are
    all-reduced, the result keeps x's shards."""
    if not _sharded_on(x, dim):
        return None
    m = x.amax(dim, keepdim=True)
    z = x - m
    return z - z.exp().sum(dim, keepdim=True).log()


def _log_softmax_backward(grad, out, dim, input_dtype):
    if not (_sharded_on(out, dim) or _sharded_on(grad, dim)):
        return None
    return grad - out.exp() * grad.sum(dim, keepdim=True)


def _masked_pl(self_t, dim, other):
    """Placements of a gather's output (or a scatter's index and source) from
    self's: a shard along ``dim`` is a masked gather, Partial; a shard of
    another dim stays where ``other`` has that dim whole."""
    out, oth = [], []
    for p in self_t.placements:
        if p.is_shard(dim % self_t.ndim):
            out.append(Partial())
            oth.append(Replicate())
        elif p.is_shard() and other.shape[p.dim] == self_t.shape[p.dim]:
            out.append(p)
            oth.append(p)
        else:
            out.append(Replicate() if p.is_shard() else p)
            oth.append(Replicate())
    return out, oth


def _gather(self_t, dim, index, sparse_grad=False):
    """``gather`` along a sharded dim: each shard gathers what it holds."""
    if not _sharded_on(self_t, dim):
        return None
    out_pl, ix_pl = _masked_pl(self_t, dim, index)
    ix = _to(index, ix_pl) if isinstance(index, DTensor) else index
    local = aten.gather.default(self_t.to_local(), dim, ix)
    return summed(DTensor.from_local(local, self_t.device_mesh, out_pl, run_check=False,
                                      shape=index.shape, stride=index.stride()))


def _scatter_add(self_t, dim, index, src, inplace=False):
    """``scatter_add`` (or ``scatter_add_``) into a tensor sharded along
    ``dim``: each shard adds the entries it holds; the result keeps self's
    shards."""
    if not _sharded_on(self_t, dim):
        return None
    _, oth = _masked_pl(self_t, dim, index)
    ix = _to(index, oth) if isinstance(index, DTensor) else index
    sr = _to(src, oth) if isinstance(src, DTensor) else src
    if inplace:
        aten.scatter_add_.default(self_t.to_local(), dim, ix, sr)
        return self_t
    local = aten.scatter_add.default(self_t.to_local(), dim, ix, sr)
    return DTensor.from_local(local, self_t.device_mesh, self_t.placements, run_check=False,
                              shape=self_t.shape, stride=self_t.stride())


def _new_filled(func):
    """``new_zeros``/``new_empty`` of a DTensor: a dim of the new shape that
    equals the operand's keeps the operand's shard of it (DTensor would
    make the new tensor whole on every rank)."""
    def rule(self_t, size, *args, **kwargs):
        pl = [p if p.is_shard() and p.dim < len(size) and size[p.dim] == self_t.shape[p.dim]
              and size[p.dim] % self_t.device_mesh.size(m) == 0 else Replicate()
              for m, p in enumerate(self_t.placements)]
        local = list(size)
        for m, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= self_t.device_mesh.size(m)
        out = func(self_t.to_local(), local, *args, **kwargs)
        return DTensor.from_local(out, self_t.device_mesh, pl, run_check=False)
    return rule


_RULES = {
    aten.flip.default: _flip,
    aten.view.default: _view,
    aten._log_softmax.default: _log_softmax,
    aten._log_softmax_backward_data.default: _log_softmax_backward,
    aten.gather.default: _gather,
    aten.scatter_add.default: _scatter_add,
    aten.scatter_add_.default: lambda *a: _scatter_add(*a, inplace=True),
    aten.new_zeros.default: _new_filled(aten.new_zeros.default),
    aten.new_empty.default: _new_filled(aten.new_empty.default),
    aten.index.Tensor: _index,
    aten.index_put_.default: _index_put,
    aten.index_add_.default: lambda *a, **k: _gathered_into(aten.index_add_.default, *a, **k),
}
