"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta
tensors over a fake world; port of ``repro.launch.dryrun``.

For each cell this shows that the distribution config is coherent (the
placements compose, every op and collective has a rule, the memory fits)
and gives the roofline's inputs, per device:

* ``memory``: ``argument_size_in_bytes`` is the sum of rank 0's local
  shard bytes over the step's inputs that some op or kernel reads
  (torch's ``Shard`` gives rank 0 the ceil chunk, which is XLA's padded
  shard; the reference's jit drops an input its step never reads, such
  as a signed pack's zero-point; ``argument_leaves`` lists every input's
  bytes and whether it is read). ``output_size_in_bytes`` is the same
  over the step's outputs, plus 8 bytes a leaf where the step returns
  more than one tensor (XLA's table of the output tuple's pointers, which
  its ``memory_analysis`` counts); a decode step's caches, updated in
  place, count as outputs, as the reference's new caches do.
  ``temp_size_in_bytes`` is the peak of the live bytes of the storages
  the step allocates, its outputs left out, tracked storage by storage
  on the dispatched ops (a storage is live from the op that makes it
  until its last tensor dies); ``step_peak_bytes`` is the same peak with
  the outputs in, what a card's allocator peaks at above the arguments.
  The kernels' meta routes allocate what the card's kernels allocate
  (``kernels/meta.py``): outputs and workspaces, never the plain
  versions' decoded temporaries. ``alias_size_in_bytes`` and
  ``generated_code_size_in_bytes`` are 0.
* ``cost``: ``flops`` by ``torch.utils.flop_counter``'s formulas on
  every local op, plus the kernels' meta routes' counts (their products
  as the plain versions' aten ops would count them). ``bytes accessed``
  is each local op's operand plus result bytes (views excluded) and the
  kernels' own: torch fuses nothing here, so it is the unfused count,
  above XLA's fused one. ``transcendentals`` are the elements of each
  exp, log, tanh, sigmoid, rsqrt, sqrt, sin, cos, erf, softmax and the
  like, and the kernels' exps and tanhs.
* ``collectives``: ``parse_collectives``'s schema (``bytes_by_op``,
  ``count_by_op``, ``total_bytes``, ``top5``) under the reference's op
  names, counted on the ``_c10d_functional`` ops DTensor issues and the
  ``c10d`` ops of the EP exchange: the bytes of each collective's result
  on one device, twice that for an all-reduce.

The world is ``launch/mesh.py:fake_world``: a fake process group of the
mesh's size in which this process is rank 0, every collective a no-op.
The parameters, optimizer state, batch and caches are meta tensors
placed by ``launch/sharding.py``'s rules, each DTensor built with
``DTensor.from_local`` from rank 0's local meta shard (shape and stride
given, nothing scattered); the train step (forward and backward), the
prefill step or the decode step then runs on them under a dispatch mode
that sees every local op beneath DTensor. A decode step attends over the
whole cache (its position is the last slot).

The dry run owns its process's default group, as the reference owns
jax's initialization: run it as a process of its own.

``--save-hlo``: torch has no HLO; the flag writes the log of the local
ops dispatched (one line an op: its name, operand shapes and dtypes), the
trace's counterpart. ``--no-extrapolate`` is accepted and changes
nothing: the reference extrapolates from shallow clones because XLA's
cost analysis counts a scanned body once, while the port's groups are a
Python loop and the full-depth trace counts every one
(``extrap`` carries the full-depth counts under the reference's keys).

Two flags beyond the reference's: ``--mesh-shape D,M`` traces over a
(data, model) mesh of that shape in place of the production ones (1,1 is
the card's one-rank mesh, the prediction ``chip_smoke.py`` holds the card
against), and ``--plain-routes`` sends meta tensors through the kernels'
plain versions (``kernels/meta.py:plain_routes``), the control whose
decoded-cache temporaries the card never allocates.

Results land in ``experiments/dryrun_torch/<cell>.json``.

Usage (on the CPU; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
      --shape decode_32k --mesh single --quant w4 --kv fp4
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.common.clock import wall_clock
from repro_torch.common.sharding import NamedSharding, set_dp_axes
from repro_torch.configs.registry import all_cells, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels import meta
from repro_torch.launch.mesh import (compat_make_mesh, fake_world,
                                     make_production_mesh, mesh_chip_count,
                                     mesh_scope)
from repro_torch.launch.sharding import (_leaves_with_path, _map_leaves,
                                         cache_shardings, data_spec,
                                         param_shardings, path_str)
from repro_torch.launch.steps import (abstract_opt, abstract_params,
                                      input_specs, make_decode_fn,
                                      make_prefill_step, make_train_step,
                                      quantize_abstract)
from repro_torch.optim.adam import AdamConfig

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s32": 4, "u32": 4,
                "s64": 8, "u64": 8, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1}

_COLL_RE = re.compile(
    r"=\s+((?:\([^)]*\)|\S+))\s+(all-gather|all-reduce|reduce-scatter|"
    r"all-to-all|collective-permute)(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")


def parse_collectives(hlo: str) -> dict:
    """Sum per-device operand bytes of every collective in optimized HLO."""
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    largest: list[tuple[float, str, str]] = []
    for m in _COLL_RE.finditer(hlo):
        ty, op = m.group(1), m.group(2)
        nbytes = 0
        for sm in _SHAPE_RE.finditer(ty):
            dt, dims = sm.group(1), sm.group(2)
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        # all-reduce moves ~2x payload (reduce-scatter + all-gather phases)
        moved = nbytes * (2 if op == "all-reduce" else 1)
        totals[op] = totals.get(op, 0) + moved
        counts[op] = counts.get(op, 0) + 1
        largest.append((moved, op, ty[:120]))
    largest.sort(reverse=True)
    return {"bytes_by_op": totals, "count_by_op": counts,
            "total_bytes": sum(totals.values()),
            "top5": [dict(bytes=b, op=o, type=t) for b, o, t in largest[:5]]}


def with_depth(cfg, n_groups: int):
    """Reduced-depth clone (same per-group body) for cost extrapolation."""
    return dataclasses.replace(
        cfg, n_layers=cfg.first_k_dense + cfg.period * n_groups)


# ---------------------------------------------------------------------------
# the trace: a dispatch mode beneath DTensor
# ---------------------------------------------------------------------------

# collective op name (``_c10d_functional.*`` / ``c10d.*``) -> the
# reference's HLO name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "erfinv", "pow",
    "_softmax", "_log_softmax", "logsumexp", "silu", "gelu", "softplus",
    "logit", "atan", "atan2", "reciprocal"}
# allocations and aliases: no bytes moved
_SKIP = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class StepTrace(TorchDispatchMode):
    """Counts a step's local ops (flops, bytes accessed, transcendentals,
    collectives) and tracks the bytes of the storages they allocate.
    DTensor ops are declined (``NotImplemented``), so DTensor runs them
    and the local ops it issues come here. The fake tensors of DTensor's
    sharding propagation are skipped."""

    def __init__(self, args, log: list | None = None):
        super().__init__()
        self.known = weakref.WeakKeyDictionary()  # storage -> serial
        for t in args:
            self.known[t.untyped_storage()] = -1      # an input
        self.read = weakref.WeakSet()    # storages some op read
        self.live = 0
        self.peak = 0
        self.events: list = []   # (serial, +bytes at birth / -bytes)
        self.cost: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        self.coll_count: collections.Counter = collections.Counter()
        self.largest: list = []
        self.n_ops = 0
        self.log = log

    def _free(self, serial: int, n: int) -> None:
        self.live -= n
        self.events.append((serial, -n))

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self.known:
                continue
            serial = len(self.events)
            self.known[st] = serial
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self.events.append((serial, n))
            weakref.finalize(st, self._free, serial, n)

    def temp_bytes(self, outs) -> int:
        """The peak of the live bytes the step allocated, the storages of
        ``outs`` (its outputs) left out."""
        skip = {self.known.get(t.untyped_storage(), -1) for t in outs}
        live = peak = 0
        for serial, n in self.events:
            if serial not in skip:
                live += n
                peak = max(peak, live)
        return peak

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        if any(_is_fake(t) for t in ins):
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ns = func.namespace
        if (ns == "aten" and func._overloadpacket not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(_is_fake(t) for t in outs):
            return out
        self.n_ops += 1
        if not func.is_view:
            for t in ins:
                self.read.add(t.untyped_storage())
        if self.log is not None:
            self.log.append(f"{func} " + " ".join(
                f"{str(t.dtype)[6:]}{list(t.shape)}" for t in ins)
                + " -> " + " ".join(f"{str(t.dtype)[6:]}{list(t.shape)}"
                                     for t in outs))
        if ns in ("_c10d_functional", "c10d"):
            self._collective(name, args, outs, ns)
        elif ns == "aten" and name not in _SKIP and not func.is_view:
            if func._overloadpacket in flop_registry:
                self.cost["flops"] += flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            self.cost["bytes accessed"] += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
            if name in _TRANSCENDENTAL:
                src = ins if name == "logsumexp" else outs
                self.cost["transcendentals"] += src[0].numel() if src else 0
        if not func.is_view:
            self._track(out)
        return out

    def _collective(self, name: str, args, outs, ns: str) -> None:
        op = _COLLECTIVES.get(name)
        if op is None:
            return
        # a functional collective's result is its output; a c10d op's the
        # tensors it writes, its first argument
        res = outs if ns == "_c10d_functional" else _tensors(args[0])
        nbytes = sum(_nbytes(t) for t in res)
        moved = nbytes * (2 if op == "all-reduce" else 1)
        self.coll_bytes[op] += moved
        self.coll_count[op] += 1
        self.largest.append((moved, op, " ".join(
            f"{str(t.dtype)[6:]}{list(t.shape)}" for t in res)[:120]))

    def collectives(self) -> dict:
        top = sorted(self.largest, reverse=True)[:5]
        return {"bytes_by_op": dict(self.coll_bytes),
                "count_by_op": dict(self.coll_count),
                "total_bytes": sum(self.coll_bytes.values()),
                "top5": [dict(bytes=b, op=o, type=t) for b, o, t in top]}


# ---------------------------------------------------------------------------
# placing abstract trees
# ---------------------------------------------------------------------------


def _local_shape(shape, mesh, pls) -> tuple:
    """Rank 0's shard of ``shape`` under ``pls``: the first (ceil) chunk
    of each dim, cut in mesh-dim order."""
    out = list(shape)
    for n, pl in zip(mesh.shape, pls):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)


def place_abstract(tree, shardings):
    """Each meta leaf of ``tree`` as a DTensor on its sharding (a tree of
    ``NamedSharding``s of the same structure), built from rank 0's local
    meta shard: nothing is scattered."""
    flat = dict(_leaves_with_path(shardings))

    def one(path, leaf):
        sh = flat[path]
        pls = sh.placements
        local = torch.empty(_local_shape(leaf.shape, sh.mesh, pls),
                            dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, sh.mesh, pls, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return _map_leaves(one, tree)


def _local_leaves(tree) -> dict:
    """path -> rank 0's local tensor, for every tensor of ``tree``."""
    return {path_str(p): t.to_local() if isinstance(t, DTensor) else t
            for p, t in _leaves_with_path(tree)
            if isinstance(t, torch.Tensor)}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _compile_cell(cfg, shape, mesh, *, quant: str, kv: str, big: bool,
                  multi_pod: bool, opts: frozenset = frozenset(),
                  save_hlo: str | None = None) -> dict:
    """Place and trace one configuration; return its record.

    ``opts`` are the reference's hillclimb variants: 'headfix'
    (head-divisibility-aware attention sharding), 'accumN' (N-way
    gradient accumulation), 'moeep' (expert-parallel MoE), 'noremat',
    'nofsdp' (serving weights TP-resident, no FSDP gathers), 'dpall'
    (pure DP over every mesh axis, params replicated)."""
    acfg = AdamConfig(lr=3e-4, moment_dtype=torch.bfloat16 if big
                      else torch.float32)
    rule_cfg = cfg if "headfix" in opts else None
    grad_accum = 1
    for o in opts:
        if o.startswith("accum"):
            grad_accum = int(o[5:])
    if "moeep" in opts:
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    if "noremat" in opts:
        cfg = dataclasses.replace(cfg, remat=False)
    use_fsdp = not ("nofsdp" in opts and shape.kind != "train")
    dpall = "dpall" in opts
    use_tp = not dpall
    if dpall:
        use_fsdp = False
    batch_axes = (("pod", "data", "model") if dpall else ("pod", "data"))
    set_dp_axes(batch_axes)  # activation hints must match input shardings
    rec: dict = {}
    t0 = wall_clock()
    meta.reset()
    with mesh_scope(mesh):
        aparams = abstract_params(cfg)
        if quant == "w4" and shape.kind != "train":
            aparams = quantize_abstract(aparams)
        ps = param_shardings(aparams, mesh, fsdp=use_fsdp,
                             fsdp_over_pod=(big and multi_pod), cfg=rule_cfg,
                             tp=use_tp)
        params = place_abstract(aparams, ps)
        specs = input_specs(cfg, shape)

        def batch_of(b):
            return place_abstract(b, {k: NamedSharding(mesh, data_spec(
                v.shape, mesh, axes=batch_axes)) for k, v in b.items()})

        if shape.kind == "train":
            aopt = abstract_opt(aparams, acfg)
            os_ = param_shardings(aopt, mesh, fsdp=not dpall,
                                  fsdp_over_pod=(big and multi_pod),
                                  cfg=rule_cfg, tp=use_tp)
            opt = place_abstract(aopt, os_)
            batch = batch_of(specs["batch"])
            step = make_train_step(cfg, acfg, grad_accum=grad_accum)
            args = (params, opt, batch)
            run = lambda: step(params, opt, batch)  # noqa: E731
        elif shape.kind == "prefill":
            batch = batch_of(specs["batch"])
            step = make_prefill_step(cfg)
            args = (params, batch)
            run = lambda: step(params, batch)  # noqa: E731
        else:
            caches = place_abstract(specs["caches"], cache_shardings(
                specs["caches"], mesh))
            token = place_abstract(specs["token"], NamedSharding(
                mesh, data_spec(specs["token"].shape, mesh)))
            step = make_decode_fn(cfg)
            args = (params, caches, token, specs["pos"])
            run = lambda: step(params, caches, token,  # noqa: E731
                               shape.seq_len - 1)
        ins = _local_leaves(args)
        rec["lower_s"] = round(wall_clock() - t0, 1)
        t1 = wall_clock()
        log = [] if save_hlo else None
        with StepTrace(ins.values(), log) as tr:
            out = run()
        rec["compile_s"] = round(wall_clock() - t1, 1)
        outs = list(_local_leaves(out).values())
        out_bytes = sum(_nbytes(t) for t in outs)
        if len(outs) > 1:
            out_bytes += 8 * len(outs)
        # the inputs the step reads: the reference's jit drops the rest
        # (a signed pack's zero-point) from its executable's arguments
        read = {path: t for path, t in ins.items()
                if t.untyped_storage() in tr.read
                or t.untyped_storage() in meta.READ
                or t is specs.get("pos")}   # a Python int in the step
        rec["argument_leaves"] = {path: [_nbytes(t), path in read]
                                  for path, t in ins.items()}
        rec["memory"] = {
            "argument_size_in_bytes": sum(_nbytes(t) for t in read.values()),
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": tr.temp_bytes(outs),
            "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": 0}
        cost = collections.Counter(tr.cost)
        cost.update(meta.COUNTS)
        rec["cost"] = {k: float(cost.get(k, 0)) for k in
                       ("flops", "bytes accessed", "transcendentals")}
        rec["collectives"] = tr.collectives()
        # the most bytes the step holds at once beyond its inputs, outputs
        # included: what the card's allocator peaks at over the arguments
        rec["step_peak_bytes"] = tr.peak
        rec["ops"] = tr.n_ops
        if save_hlo:
            with open(save_hlo, "w") as f:
                f.write("\n".join(log) + "\n")
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             quant: str = "bf16", kv: str = "bf16", opts: frozenset = frozenset(),
             save_hlo: str | None = None, extrapolate: bool = True,
             cfg=None, shape=None, mesh_shape: tuple | None = None,
             plain: bool = False) -> dict:
    """One cell over a fake world of the production mesh's size (or of a
    (data, model) ``mesh_shape``), traced at full depth: every group runs
    in the port's Python loop, so the counts are exact with no shallow
    clones (``extrapolate`` is accepted and changes nothing). ``cfg`` and
    ``shape`` override the registry's (a smoke config, a small shape);
    ``plain`` traces the kernels' plain versions (the control)."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, kv_dtype=kv)
    chips = (math.prod(mesh_shape) if mesh_shape else
             512 if multi_pod else 256)
    big = cfg.param_count() > 3e11  # kimi-class: bf16 moments + pod-FSDP
    rec = {"arch": arch, "shape": shape_name,
           "mesh": _mesh_name(multi_pod, mesh_shape), "chips": chips,
           "quant": quant, "kv": kv, "kind": shape.kind,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "n_groups": cfg.n_groups, "opts": sorted(opts)}
    if plain:
        rec["routes"] = "plain"
    with fake_world(chips), (meta.plain_routes() if plain
                             else contextlib.nullcontext()):
        mesh = (compat_make_mesh(tuple(mesh_shape), ("data", "model"))
                if mesh_shape else make_production_mesh(multi_pod=multi_pod))
        rec["chips"] = mesh_chip_count(mesh)
        rec.update(_compile_cell(cfg, shape, mesh, quant=quant, kv=kv,
                                 big=big, multi_pod=multi_pod, opts=opts,
                                 save_hlo=save_hlo))
    rec["extrap"] = {
        "cost": dict(rec["cost"]),
        "collective_bytes_by_op": rec["collectives"]["bytes_by_op"],
        "collective_bytes": rec["collectives"]["total_bytes"],
    }
    return rec


def _mesh_name(multi_pod: bool, mesh_shape) -> str:
    if mesh_shape:
        return "x".join(str(n) for n in mesh_shape)
    return "multi" if multi_pod else "single"


def cell_id(rec_or_args) -> str:
    r = rec_or_args
    extra = ""
    if r.get("quant", "bf16") != "bf16":
        extra += f"_{r['quant']}"
    if r.get("kv", "bf16") != "bf16":
        extra += f"_kv{r['kv']}"
    for o in r.get("opts", []) or []:
        extra += f"_{o}"
    if r.get("routes") == "plain":
        extra += "_plain"
    return f"{r['arch']}_{r['shape']}_{r['mesh']}{extra}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="bf16", choices=["bf16", "w4"])
    ap.add_argument("--kv", default="bf16", choices=["bf16", "fp8", "fp4"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-hlo", default=None,
                    help="write the traced local ops here (torch has no "
                         "HLO)")
    ap.add_argument("--opts", default="",
                    help="comma list of hillclimb variants, e.g. headfix,accum4")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="accepted for the reference's CLI; the full-depth "
                         "trace is exact")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="D,M: a (data, model) mesh of that shape in place "
                         "of --mesh's (1,1: the card's one-rank mesh)")
    ap.add_argument("--plain-routes", action="store_true",
                    help="meta tensors take the kernels' plain versions "
                         "(the control)")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    os.makedirs(args.out, exist_ok=True)

    cells = all_cells()
    if args.arch != "all":
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape != "all":
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = [False] if mesh_shape else {
        "single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    opts = frozenset(o for o in args.opts.split(",") if o)

    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec_key = cell_id({"arch": arch, "shape": shape,
                               "mesh": _mesh_name(mp, mesh_shape),
                               "quant": args.quant, "kv": args.kv,
                               "opts": sorted(opts),
                               "routes": "plain" if args.plain_routes
                               else None})
            path = os.path.join(args.out, rec_key + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {rec_key}")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=mp, quant=args.quant,
                               kv=args.kv, opts=opts, save_hlo=args.save_hlo,
                               extrapolate=not args.no_extrapolate,
                               mesh_shape=mesh_shape,
                               plain=args.plain_routes)
                rec["ok"] = True
                coll = rec["collectives"]["total_bytes"] / 1e6
                mem = rec["memory"]["temp_size_in_bytes"] / 1e9
                print(f"[ok]   {rec_key}: compile={rec['compile_s']}s "
                      f"flops/dev={rec['cost'].get('flops', 0):.3e} "
                      f"coll={coll:.1f}MB/dev temp={mem:.2f}GB/dev")
            except Exception as e:
                n_fail += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": _mesh_name(mp, mesh_shape), "ok": False,
                       "quant": args.quant, "kv": args.kv,
                       "opts": sorted(opts),
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {rec_key}: {type(e).__name__}: {e}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done: {len(cells) * len(meshes)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
