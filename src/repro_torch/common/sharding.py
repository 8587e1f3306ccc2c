"""Mesh-agnostic activation sharding hints; port of
``repro.common.sharding``, onto ``torch.distributed`` DeviceMesh and
DTensor.

Model code annotates activations with *logical* specs (axis-name
strings); ``shard_hint`` filters them against the ambient mesh (axes that
exist, divisibility), so the same model runs meshless, on a 1-rank mesh
or on the (2, 16, 16) multi-pod mesh without edits.

A spec is a ``P``, the reference's ``PartitionSpec``: one entry a tensor
dim, ``None`` (replicated), a mesh axis name, or a tuple of names (the dim
split over each in turn). ``placements`` turns a spec on a named
``DeviceMesh`` into DTensor placements: an axis entry on dim ``d``
becomes ``Shard(d)`` on that mesh dim. DTensor splits a dim sharded over
several mesh dims in mesh-dim order, which is JAX's layout only where the
tuple lists its axes in mesh order; every tuple the rules build does
(("pod", "data"), ("pod", "data", "model")), and ``placements`` raises on
one that does not. ``NamedSharding`` pairs a mesh with a spec, as JAX's.

The ambient mesh is a context variable that ``scope`` (the reference's
``launch.mesh.mesh_scope``) sets. A mesh is read through ``mesh_dim_names`` and ``shape`` only, so the
spec rules run on any object with those two (the tests' fake meshes of
256 and 512 ranks).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

# Logical data-parallel axes. ``DP`` is a sentinel resolved when a hint is
# read, against ``_DP_AXES``, so model modules that imported it by value
# still honour set_dp_axes() (the small-model pure-DP mode extends batch
# sharding over the model axis, and the activation hints must agree with
# the input shardings).
DP = "__dp__"
MODEL = "model"
_DP_AXES: tuple = ("pod", "data")

AMBIENT: contextvars.ContextVar = contextvars.ContextVar("ambient_mesh",
                                                         default=None)


def set_dp_axes(axes: tuple) -> None:
    global _DP_AXES
    _DP_AXES = tuple(axes)


def _expand(entry):
    if entry == DP:
        return _DP_AXES
    if isinstance(entry, tuple):
        out = []
        for e in entry:
            out.extend(_DP_AXES if e == DP else (e,))
        return tuple(out)
    return entry


class P(tuple):
    """PartitionSpec: ``P(*entries)``, one entry a dim (trailing dims
    unnamed are replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def ambient_mesh():
    """The mesh of the innermost ``mesh_scope``, or None."""
    return AMBIENT.get()


def _filter_entry(entry, dim: int, axis_sizes: dict[str, int]):
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    kept = []
    prod = 1
    for n in names:
        if n in axis_sizes and dim % (prod * axis_sizes[n]) == 0:
            kept.append(n)
            prod *= axis_sizes[n]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def logical_spec(shape: tuple, entries: tuple) -> P:
    """Resolve logical entries against the ambient mesh; P() if no mesh."""
    mesh = ambient_mesh()
    if mesh is None:
        return P()
    sizes = axis_sizes(mesh)
    resolved = [_filter_entry(_expand(e), shape[i], sizes)
                for i, e in enumerate(entries)]
    return P(*resolved)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where dim ``d``'s entry names that mesh dim, else
    ``Replicate()``. An axis of size 1 cuts nothing and stays
    ``Replicate()``: the same layout, which every DTensor op covers (torch
    2.11 has no rule for a view that merges two dims sharded on size-1
    axes)."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dim {d} lists mesh "
                             f"axes out of mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def spec_of(placements_: tuple, mesh) -> P:
    """The inverse of ``placements``: the spec a DTensor's placements
    stand for."""
    names = tuple(mesh.mesh_dim_names)
    dims: dict[int, list] = {}
    for name, pl in zip(names, placements_):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} has no spec")
    if not dims:
        return P()
    return P(*(None if d not in dims else
               (dims[d][0] if len(dims[d]) == 1 else tuple(dims[d]))
               for d in range(max(dims) + 1)))


def sharding_of(leaf) -> NamedSharding | None:
    """A DTensor's mesh and spec; None for anything else."""
    if not isinstance(leaf, DTensor):
        return None
    return NamedSharding(leaf.device_mesh,
                         spec_of(leaf.placements, leaf.device_mesh))


def shard_hint(x, *entries):
    """The eager counterpart of ``with_sharding_constraint``: a DTensor
    redistributed to the resolved spec on the ambient mesh; anything else,
    or no mesh, passes through.

    entries: per-dim logical axis name(s) or None, e.g.
    ``shard_hint(h, DP, None, None)`` for (batch, seq, d_model).
    """
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_spec(tuple(x.shape), entries)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def heads_view(x, n_heads: int):
    """A DTensor ``x`` (..., n_heads * hd) made ready for its view as
    (..., n_heads, hd): a mesh dim that cuts the last dim keeps its cut
    only where the heads divide over it (then the cut falls on the heads),
    else it is gathered there, GSPMD's reshard of a cut across heads
    (DTensor has no rule for that view). Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    last, cut, pls = x.ndim - 1, 1, list(x.placements)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == last:
            if n_heads % (cut * x.device_mesh.shape[i]) == 0:
                cut *= x.device_mesh.shape[i]
            else:
                pls[i] = Replicate()
    if pls == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pls)


def like(t, ref):
    """``t``, a tensor every rank holds whole (a mask, a table, a zero
    state), as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor; else ``t``. The model's constants meet its activations
    through it: DTensor refuses to mix a plain tensor of more than one
    element with a DTensor, and the permission to (``implicit_replication``)
    does not reach the autograd threads that run a backward on the card in
    torch 2.11."""
    if not isinstance(ref, DTensor) or not isinstance(t, torch.Tensor) \
            or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


@contextlib.contextmanager
def scope(mesh):
    """``mesh`` as the ambient mesh while the context is open
    (``launch/mesh.py:mesh_scope``)."""
    token = AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        AMBIENT.reset(token)


def recompute_contexts():
    """``context_fn`` for a checkpointed region: its recomputation, which
    runs on the backward's thread, under the ambient mesh of the forward
    (a context variable does not cross threads)."""
    return contextlib.nullcontext(), scope(ambient_mesh())


def grad_placements(pls) -> list:
    """The placements of the gradient of an input that a local function
    took whole while its other inputs were cut by ``pls``: a partial sum
    over each mesh dim that cuts them."""
    return [Partial() if isinstance(pl, Shard) else Replicate() for pl in pls]


def over_batch(fn, x, whole: tuple):
    """``fn(x, *whole)`` on each rank's local tensors: the DTensor ``x``
    cut along its batch dim 0 over the data-parallel axes that divide it,
    the ``whole`` inputs (parameters) gathered whole; the output cut like
    ``x``, the parameters' gradients reduced over the batch's ranks. The
    explicit placements of a site whose ops DTensor does not cover on
    every torch version."""
    mesh = x.device_mesh
    batch = _filter_entry(_expand(DP), x.shape[0], axis_sizes(mesh))
    pls = list(placements(P(batch), mesh))
    return local_map(
        fn, out_placements=pls,
        in_placements=(pls,) + ([Replicate()] * mesh.ndim,) * len(whole),
        in_grad_placements=(pls,) + (grad_placements(pls),) * len(whole),
        device_mesh=mesh, redistribute_inputs=True)(x, *whole)


def to_full(x):
    """A DTensor gathered whole onto every rank as a plain tensor (a
    metric, a loss); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def is_distributed(tree_leaves_: list) -> bool:
    return any(isinstance(l, DTensor) for l in tree_leaves_)

