"""The kernels on a mesh: the W4 products, the act snap and the FP4 cache
ops that a model calls on DTensors, each run by ``kernels/ops.py`` on
every rank's local shards, as GSPMD partitions the reference's ops. On
plain tensors each function here is the ``kernels/ops.py`` op itself;
``kernels/ops.py`` sees plain tensors only.

Each op is ``local_map``'s pattern, written out: the inputs redistributed
to the placements stated below, the op on the local shards, the output
wrapped with its placements and its global shape given (a cut that does
not divide gives rank 0 the ceil chunk, where ``local_map`` would take
the global shape for an even cut's).

  * A W4 product x (..., K) @ a (K, N/2) split-half pack, per mesh axis:
    x's rows cut are kept and the pack gathered over that axis (FSDP); a
    pack cut over its contraction takes x cut to match and gives a
    partial sum; a pack cut over its byte columns holds output columns j
    and j + N/2 for each byte column j it holds, so the local product is
    a shard of the (..., 2, N/2) view of the output, which is gathered
    over that axis, put back to (..., N) and cut over its columns again
    (a slice).
  * The act snap reduces a partial sum first: the snap is not linear.
  * ``kv4_store`` writes the new token on the ranks that hold its slot,
    over the cache's batch and kv-head cuts.
  * ``kv4_attend`` gathers a cache cut over its slots whole over those
    axes and attends over one rank's whole cache. That is this port's
    partitioning, not the reference's: XLA partitions the reference's
    attention over the slots, with reductions of the softmax's max and
    sum and of the output, and gathers no cache. The gather is what the
    dry run records as the decode cells' all-gather bytes and most of
    their temp bytes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _wrap(out: torch.Tensor, mesh, pls, shape) -> DTensor:
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, pls, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _local_qp(qp):
    return dataclasses.replace(qp, maxval=_local(qp.maxval),
                               zero_point=_local(qp.zero_point))


def _product(x: DTensor, pw: PackedW4, run):
    """``run(x_local, pack_local)`` on each rank's shards of x (..., K)
    and the (K, N/2) pack, as a DTensor (..., N)."""
    mesh, nd = x.device_mesh, x.ndim
    packed, n = pw.packed, 2 * pw.packed.shape[-1]
    xs, ws, outs, cols = [], [], [], None
    for i in range(mesh.ndim):
        xp = x.placements[i]
        wp = (packed.placements[i] if isinstance(packed, DTensor)
              else Replicate())
        if isinstance(xp, Shard) and xp.dim < nd - 1:
            xs.append(xp), ws.append(Replicate()), outs.append(xp)
        elif isinstance(wp, Shard) and wp.dim == 0:
            xs.append(Shard(nd - 1)), ws.append(wp), outs.append(Partial())
        elif isinstance(wp, Shard) and cols is None:
            cols = i
            xs.append(Replicate()), ws.append(wp), outs.append(Shard(nd))
        else:
            xs.append(Replicate()), ws.append(Replicate())
            outs.append(Replicate())
    x = x.redistribute(mesh, xs)
    scale, zero_point = _whole(pw.scale), _whole(pw.zero_point)
    if isinstance(packed, DTensor):
        packed = packed.redistribute(mesh, ws)
        local_n, offset = compute_local_shape_and_global_offset(
            packed.shape, mesh, packed.placements)
        if cols is not None and scale.numel() > 1:
            # this rank's output columns: j and j + N/2 for its bytes j
            j = torch.arange(offset[-1], offset[-1] + local_n[-1],
                             device=scale.device)
            scale, zero_point = (t[torch.cat([j, j + n // 2])]
                                 for t in (scale, zero_point))
    local = dataclasses.replace(pw, packed=_local(packed), scale=scale,
                                zero_point=zero_point)
    out = run(x.to_local(), local)
    lead = tuple(x.shape[:-1])
    if cols is None:
        return _wrap(out, mesh, outs, (*lead, n))
    y = _wrap(out.unflatten(-1, (2, out.shape[-1] // 2)), mesh, outs,
              (*lead, 2, n // 2))
    # gathered here: torch 2.11's view rule will not redistribute itself
    y = y.redistribute(mesh, [Replicate() if i == cols else p
                              for i, p in enumerate(outs)])
    return y.reshape(*lead, n).redistribute(
        mesh, [Shard(nd - 1) if i == cols else p
               for i, p in enumerate(y.placements)])


def w4_matmul(x: torch.Tensor, pw: PackedW4) -> torch.Tensor:
    """``ops.w4_matmul`` (K2 weight-only) on a mesh."""
    if not isinstance(x, DTensor):
        return ops.w4_matmul(x, pw)
    return _product(x, pw, ops.w4_matmul)


def w4a4_matmul(x: torch.Tensor, pw: PackedW4, act_qp) -> torch.Tensor:
    """``ops.w4a4_matmul`` (K2) on a mesh."""
    if act_qp is None:
        return w4_matmul(x, pw)
    if not isinstance(x, DTensor):
        return ops.w4a4_matmul(x, pw, act_qp)
    qp = _local_qp(act_qp)
    return _product(x, pw, lambda xl, pl: ops.w4a4_matmul(xl, pl, qp))


def msfp_quantize(x: torch.Tensor, qp, folded: bool = False
                  ) -> torch.Tensor:
    """``ops.msfp_quantize`` (K1) on each rank's shard of x, a partial sum
    reduced first."""
    if not isinstance(x, DTensor):
        return ops.msfp_quantize(x, qp, folded)
    pls = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pls)
    return _wrap(ops.msfp_quantize(x.to_local(), _local_qp(qp), folded),
                 x.device_mesh, pls, x.shape)


def _cache_placements(cache: DTensor) -> list:
    """A (B, K, ...) decode input's placements matching a (B, S, K,
    hd/2) cache's: its batch cut as the cache's, its kv heads (dim 1) as
    the cache's dim 2, whole where the cache is cut over its slots."""
    def one(p):
        if isinstance(p, Shard) and p.dim in (0, 2):
            return Shard(p.dim // 2)
        return Replicate()
    return [one(p) for p in cache.placements]


def kv4_store(k_new, v_new, k, v, k_scale, v_scale, pos: int) -> None:
    """``ops.kv4_store`` on a mesh: the ranks whose cache shard holds slot
    ``pos`` write it."""
    if not isinstance(k, DTensor):
        return ops.kv4_store(k_new, v_new, k, v, k_scale, v_scale, pos)
    mesh, pls = k.device_mesh, _cache_placements(k)
    k_new, v_new = (t.redistribute(mesh, pls).to_local()
                    for t in (k_new, v_new))
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh,
                                                      k.placements)
    k, v, k_scale, v_scale = (_local(t) for t in (k, v, k_scale, v_scale))
    pos -= offset[1]
    if 0 <= pos < k.shape[1]:
        ops.kv4_store(k_new, v_new, k, v, k_scale, v_scale, pos)


def kv4_attend(q, k, v, k_scale, v_scale, valid_len: int, scale: float,
               softcap: float | None = None) -> torch.Tensor:
    """``ops.kv4_attend`` on a mesh: q cut as the cache's batch and kv
    heads, a cache cut over its slots gathered whole over those axes."""
    if not isinstance(k, DTensor):
        return ops.kv4_attend(q, k, v, k_scale, v_scale, valid_len, scale,
                              softcap)
    mesh, pls = k.device_mesh, _cache_placements(k)
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in k.placements]
    k, v, k_scale, v_scale = (t.redistribute(mesh, whole).to_local()
                              for t in (k, v, k_scale, v_scale))
    q = q.redistribute(mesh, pls)
    o = ops.kv4_attend(q.to_local(), k, v, k_scale, v_scale, valid_len,
                       scale, softcap)
    return _wrap(o, mesh, pls, q.shape)
