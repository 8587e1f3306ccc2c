"""Parameter, input and cache sharding rules (logical -> mesh spec); port
of ``repro.launch.sharding``.

Strategy (Megatron-style TP x FSDP), the reference's:
  * ``model`` axis: tensor parallel: attention heads, MLP hidden, MoE
    experts, vocab (embed rows / lm_head cols).
  * ``data`` axis: batch + FSDP (ZeRO-3): every >=2D weight additionally
    shards a non-TP dim over ``data``.
  * ``pod`` axis (multi-pod): batch DP; optionally joins FSDP
    (``fsdp_over_pod``) for models that cannot fit a single pod's memory.

Rules are path-pattern based so they cover every architecture family with
one table; divisibility is checked per dim and axes that don't divide are
dropped (batch 1 stays unsharded).

The specs are ``common/sharding.py:P`` and the shardings its
``NamedSharding`` (a mesh and a spec); ``place`` puts a tree onto them as
DTensors, where DTensor's sharding propagation plays GSPMD's part: the
data-parallel gradient reduction and the FSDP gathers follow from the
placements. A mesh is read through ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

from torch.distributed.tensor import distribute_tensor

from repro_torch.common.sharding import NamedSharding, P, axis_sizes
from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.core.qmodule import PackedW4

PACKED_FIELDS = ("packed", "scale", "zero_point")


def _fits(dim: int, axes: tuple[str, ...], sizes: dict) -> tuple | None:
    kept, prod = [], 1
    for a in axes:
        if a in sizes and dim % (prod * sizes[a]) == 0:
            kept.append(a)
            prod *= sizes[a]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


# (regex on path, per-dim logical axes counted from the LAST dims).
# 'F' = fsdp axes, 'M' = model axis. Entries align to the trailing dims so
# the same rule covers stacked (G, ...) weights (leading dims replicate).
_RULES: list[tuple[str, tuple]] = [
    # embed: vocab-sharded only (sharding D as well makes the token gather
    # a full rematerialisation)
    (r"embed$", ("M", None)),                      # (V, D)
    (r"lm_head/w$", ("F", "M")),                   # (D, V)
    (r"vision_proj/w$", (None, None)),
    (r"(wq|wk|wv)/w$", ("F", "M")),                # (D, H*hd)
    (r"wo/w$", ("M", "F")),                        # (H*hd, D)
    (r"(gate|up)/w$", ("F", "M")),                 # (D, ff)
    (r"down/w$", ("M", "F")),                      # (ff, D)
    (r"router/w$", (None, None)),
    (r"w_gate$", ("M", "F", None)),                # (E, D, f)
    (r"w_up$", ("M", "F", None)),
    (r"w_down$", ("M", None, "F")),                # (E, f, D)
    (r"in_proj/w$", ("F", "M")),                   # (D, d_in_proj)
    (r"out_proj/w$", ("M", "F")),                  # (d_inner, D)
    (r"conv_w$", (None, "M")),                     # (K, conv_dim)
    (r"(wq|wk|wv)/b$", ("M",)),
    (r"(gate|up)/b$", ("M",)),
]


_HEAD_RULES = (r"(wq|wo)/(w|b)$", r"(wk|wv)/(w|b)$")


def _head_ok(path: str, cfg, model_size: int) -> bool:
    """TP on attention projections only when the head count divides the
    model axis: sharding the flat (H*hd) dim across head boundaries makes
    every (B,S,H,hd) reshape a reshard."""
    if cfg is None:
        return True
    if re.search(_HEAD_RULES[0], path):
        return cfg.n_heads % model_size == 0
    if re.search(_HEAD_RULES[1], path):
        return cfg.n_kv % model_size == 0
    return True


def param_spec(path: str, shape: tuple, mesh, *,
               fsdp: bool = True, fsdp_over_pod: bool = False,
               cfg=None, tp: bool = True) -> P:
    sizes = axis_sizes(mesh)
    if not tp or not _head_ok(path, cfg, sizes.get("model", 1)):
        sizes = {k: v for k, v in sizes.items() if k != "model"}
    fsdp_axes: tuple = ()
    if fsdp:
        fsdp_axes = ("pod", "data") if fsdp_over_pod else ("data",)
    for pat, logical in _RULES:
        if re.search(pat, path):
            n_extra = len(shape) - len(logical)
            entries: list = [None] * n_extra
            for i, ent in enumerate(logical):
                dim = shape[n_extra + i]
                if ent == "M":
                    entries.append(_fits(dim, ("model",), sizes))
                elif ent == "F":
                    entries.append(_fits(dim, fsdp_axes, sizes))
                else:
                    entries.append(None)
            return P(*entries)
    # default: replicate (norms, scalars, biases, conv kernels of the UNet)
    return P()


def path_str(path) -> str:
    """A key path (dict keys, list indices as ``#i``, PackedW4 fields)
    '/'-joined, as the reference spells a JAX key path."""
    return "/".join(f"#{k}" if isinstance(k, int) else str(k) for k in path)


def _leaves_with_path(tree, path=()):
    """(key path, leaf) of every tensor of ``tree``, descending dicts,
    lists and PackedW4's three arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, (*path, i))
    elif isinstance(tree, PackedW4):
        for f in PACKED_FIELDS:
            yield from _leaves_with_path(getattr(tree, f), (*path, f))
    else:
        yield path, tree


def _map_leaves(fn, tree, path=()):
    """``fn(key path, leaf)`` over the leaves ``_leaves_with_path`` walks,
    in the tree's own structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, (*path, i))
                          for i, v in enumerate(tree))
    if isinstance(tree, PackedW4):
        return dataclasses.replace(tree, **{
            f: _map_leaves(fn, getattr(tree, f), (*path, f))
            for f in PACKED_FIELDS})
    return fn(path, tree)


def param_shardings(params: Any, mesh, *, fsdp: bool = True,
                    fsdp_over_pod: bool = False, cfg=None,
                    tp: bool = True) -> Any:
    """NamedSharding tree matching params (descends PackedW4:
    '.../w/packed' inherits the dense weight's rule, its dims already
    halved passing the same divisibility check; scales and zero-points
    replicate). ``cfg`` (an LMConfig) enables the head-divisibility
    constraint."""

    def one(path, leaf):
        p = path_str(path)
        if p.endswith("/packed"):
            p = p[: -len("/packed")]
        elif p.endswith("/scale") or p.endswith("/zero_point"):
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, param_spec(
            p, tuple(leaf.shape), mesh, fsdp=fsdp,
            fsdp_over_pod=fsdp_over_pod, cfg=cfg, tp=tp))

    return _map_leaves(one, params)


def like_tree(shardings: Any, tree: Any) -> Any:
    """Optimizer-state shardings mirror the param shardings."""
    return _map_leaves(lambda _p, _l: shardings, tree)


def place(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` distributed onto its sharding (the tree of
    ``param_shardings`` or ``cache_shardings`` of the same structure):
    every rank holds the whole tensor beforehand, and keeps its shard."""
    flat_s = dict(_leaves_with_path(shardings))
    return _map_leaves(lambda p, leaf: distribute_tensor(
        leaf, flat_s[p].mesh, flat_s[p].placements), tree)


# ---------------------------------------------------------------------------
# inputs / caches
# ---------------------------------------------------------------------------

DP_AXES = ("pod", "data")


def data_spec(shape: tuple, mesh, *, batch_dim: int = 0,
              axes: tuple = DP_AXES) -> P:
    sizes = axis_sizes(mesh)
    entries: list = [None] * len(shape)
    entries[batch_dim] = _fits(shape[batch_dim], axes, sizes)
    return P(*entries)


def cache_spec(path: str, shape: tuple, mesh) -> P:
    """KV caches (G, B, S, K, hd) / packed variants / SSM states.

    Batch shards over DP; the kv-head (or SSM-head) dim over model.
    """
    sizes = axis_sizes(mesh)
    entries: list = [None] * len(shape)
    if len(shape) >= 2:
        # find batch dim: stacked caches lead with groups
        bdim = 1 if len(shape) >= 4 else 0
        entries[bdim] = _fits(shape[bdim], DP_AXES, sizes)
    if re.search(r"(^|/)(k|v|k_scale|v_scale)$", path) and len(shape) >= 4:
        kdim = len(shape) - (1 if path.endswith("_scale") else 2)
        entries[kdim] = _fits(shape[kdim], ("model",), sizes)
    elif path.endswith("state") and len(shape) >= 3:
        entries[-3] = _fits(shape[-3], ("model",), sizes)  # SSM heads
    elif path.endswith("conv"):
        entries[-1] = _fits(shape[-1], ("model",), sizes)
    return P(*entries)


def cache_shardings(cache_tree: Any, mesh) -> Any:
    flat = flatten_paths(cache_tree)
    return unflatten_paths({
        p: NamedSharding(mesh, cache_spec(p, tuple(l.shape), mesh))
        for p, l in flat.items()})
