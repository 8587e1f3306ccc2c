"""MSE-minimizing search for quantizer parameters (paper Algorithm 1);
port of ``repro.quant.search``.

The paper's Alg. 1 loops over (format, maxval, zp). Here each format's
whole candidate grid is one batched tensor op: the (candidates, samples)
qdq of the same samples, then the per-candidate mean squared error, on
the device the samples live on (the card unless the caller asks for the
CPU). The grids are ``np.linspace`` in f64 cast to f32 and the argmin is
``np.argmin`` on the host, as in the reference. The candidates' qdq takes
the compiled form (``fakequant``: the reference's grids run under
``jit``), so each candidate's quantized samples equal the reference's bit
for bit; only the order of the f32 sums in the mean differs.

Search spaces follow App. B / C / Table 6:
  weights      maxval in linspace(lo_frac * maxval_0, 2 * maxval_0, 100)
               (lo_frac 0.8 at 4 bits, 0.9 at 6/8), the signed formats
  activations  maxval in linspace(0, maxval_0, 100)[1:], every ExMy of the
               bit-width, zp in linspace(-0.3, 0, 6) for unsigned ones
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.quant import formats as F
from repro_torch.quant.fakequant import (KIND_FP_SIGNED, KIND_FP_UNSIGNED,
                                         KIND_INT_AFFINE, QuantizerParams,
                                         fp_qdq, int_qdq)

# candidates x samples of one batched qdq: a format's whole grid at the
# reference's caps (594 x 32768 for an AAL site) is one op
BATCH_ELEMENTS = 1 << 25


def tie_bound(n: int) -> float:
    """Relative bound on two f32 means of the same n terms summed in two
    orders: pairwise (tree) summation errs by at most ceil(log2 n) units
    of 2^-24 of the sum in each order, so the two differ by at most twice
    that (1.9e-6 at n = 65536). Two searches of the same samples whose
    picks differ within it are a near-tie, not a fault."""
    return 2 * int(np.ceil(np.log2(max(n, 2)))) * 2.0**-24


@dataclasses.dataclass(frozen=True)
class SearchResult:
    params: QuantizerParams
    mse: float
    per_format: dict[str, float]   # each format's best MSE (Fig. 4 data)


def _device(x, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device("cuda")


def _subsample(x, cap: int = 1 << 16, device=None) -> torch.Tensor:
    """Deterministic strided subsample so the search cost is bounded: the
    ravelled f32 values, every ``ceil(n / cap)``-th when above ``cap``."""
    dev = _device(x, device)
    if isinstance(x, torch.Tensor):
        flat = x.detach().reshape(-1).to(dev, torch.float32)
    else:
        flat = torch.from_numpy(
            np.ascontiguousarray(np.ravel(x), np.float32)).to(dev)
    n = flat.numel()
    if n <= cap:
        return flat
    return flat[:: int(np.ceil(n / cap))]


def _mses(xs: torch.Tensor, qdq: Callable, *params: torch.Tensor
          ) -> np.ndarray:
    """Mean of (xs - qdq(xs, *params))**2 per candidate: ``params`` are
    (C,) f32 tensors, evaluated as (C, 1) columns against the (1, S)
    samples, in row blocks of at most ``BATCH_ELEMENTS``."""
    rows = max(1, BATCH_ELEMENTS // max(1, xs.numel()))
    x = xs[None, :]
    out = []
    for i in range(0, params[0].numel(), rows):
        cols = [p[i:i + rows, None] for p in params]
        out.append(((x - qdq(x, *cols)) ** 2).mean(dim=1))
    return torch.cat(out).cpu().numpy()


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)


def _scalar(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def mse_signed_grid(xs: torch.Tensor, fmt: F.FPFormat,
                    maxvals: torch.Tensor) -> np.ndarray:
    return _mses(xs, lambda x, mv: fp_qdq(x, fmt, mv), maxvals)


def mse_unsigned_grid(xs: torch.Tensor, fmt: F.FPFormat,
                      maxvals: torch.Tensor, zps: torch.Tensor
                      ) -> np.ndarray:
    """(len(maxvals), len(zps)) MSEs over the meshgrid, maxval-major."""
    mv_g, zp_g = torch.meshgrid(maxvals, zps, indexing="ij")
    mses = _mses(xs, lambda x, mv, zp: fp_qdq(x, fmt, mv, zp),
                 mv_g.reshape(-1), zp_g.reshape(-1))
    return mses.reshape(tuple(mv_g.shape))


def search_signed_fp(x, bits: int, *,
                     formats: Sequence[F.FPFormat] | None = None,
                     maxval_grid: np.ndarray | None = None,
                     lo_frac: float | None = None, device=None
                     ) -> SearchResult:
    """Stage-1 search: signed FP over (format, maxval)."""
    xs = _subsample(x, device=device)
    maxval_0 = max(float(xs.abs().max()), 1e-8)
    if formats is None:
        formats = F.signed_formats(bits)
    if maxval_grid is None:
        if lo_frac is None:
            lo_frac = 0.8 if bits <= 4 else 0.9
        maxval_grid = np.linspace(lo_frac * maxval_0, 2.0 * maxval_0, 100)
    grid = _f32(maxval_grid, xs.device)

    best = None
    per_format = {}
    for fmt in formats:
        mses = mse_signed_grid(xs, fmt, grid)
        i = int(np.argmin(mses))
        per_format[fmt.name] = float(mses[i])
        if best is None or mses[i] < best[0]:
            best = (float(mses[i]), fmt, float(maxval_grid[i]))
    mse, fmt, mv = best
    qp = QuantizerParams(KIND_FP_SIGNED, fmt.exp_bits, fmt.man_bits, bits,
                         _scalar(mv, xs.device), _scalar(0.0, xs.device))
    return SearchResult(qp, mse, per_format)


def search_unsigned_fp(x, bits: int, *,
                       formats: Sequence[F.FPFormat] | None = None,
                       maxval_grid: np.ndarray | None = None,
                       zp_grid: np.ndarray | None = None,
                       with_zero_point: bool = True, device=None
                       ) -> SearchResult:
    """Stage-2 search: unsigned FP (+ zero-point) over (format, maxval, zp)."""
    xs = _subsample(x, device=device)
    maxval_0 = max(float(xs.max()), 1e-8)
    if formats is None:
        formats = F.unsigned_formats(bits)
    if maxval_grid is None:
        maxval_grid = np.linspace(0.0, maxval_0, 100)[1:]
    if zp_grid is None:
        zp_grid = np.linspace(-0.3, 0.0, 6) if with_zero_point else np.zeros(1)
    grid = _f32(maxval_grid, xs.device)
    zgrid = _f32(zp_grid, xs.device)

    best = None
    per_format = {}
    for fmt in formats:
        mses = mse_unsigned_grid(xs, fmt, grid, zgrid)
        i, j = np.unravel_index(int(np.argmin(mses)), mses.shape)
        per_format[fmt.name] = float(mses[i, j])
        if best is None or mses[i, j] < best[0]:
            best = (float(mses[i, j]), fmt, float(maxval_grid[i]),
                    float(zp_grid[j]))
    mse, fmt, mv, zp = best
    qp = QuantizerParams(KIND_FP_UNSIGNED, fmt.exp_bits, fmt.man_bits, bits,
                         _scalar(mv, xs.device), _scalar(zp, xs.device))
    return SearchResult(qp, mse, per_format)


def search_int_affine(x, bits: int, *, symmetric: bool = False,
                      n_grid: int = 80, device=None) -> SearchResult:
    """INT-affine baseline search (Q-Diffusion-style min/max + MSE refine)."""
    xs = _subsample(x, device=device)
    dev = xs.device
    x_min = float(xs.min())
    x_max = float(xs.max())
    if symmetric:
        m0 = max(abs(x_min), abs(x_max), 1e-8)
        cands = np.linspace(0.5 * m0, 1.0 * m0, n_grid)
        mses = _mses(xs, lambda x, mv: int_qdq(x, bits, mv, form="compiled"),
                     _f32(cands, dev))
        i = int(np.argmin(mses))
        qp = QuantizerParams(KIND_INT_AFFINE, 0, 0, bits,
                             _scalar(cands[i], dev), _scalar(0.0, dev))
        return SearchResult(qp, float(mses[i]), {"int_sym": float(mses[i])})
    # Affine: shrink the (min, max) window jointly, the window's ends in f32
    fracs = np.linspace(0.6, 1.0, n_grid)
    fr = _f32(fracs, dev)
    mses = _mses(xs, lambda x, hi, lo: int_qdq(x, bits, hi, lo,
                                               symmetric=False,
                                               form="compiled"),
                 _scalar(x_max, dev) * fr, _scalar(x_min, dev) * fr)
    i = int(np.argmin(mses))
    qp = QuantizerParams(KIND_INT_AFFINE, 0, 0, bits,
                         _scalar(x_max * fracs[i], dev),
                         _scalar(x_min * fracs[i], dev))
    return SearchResult(qp, float(mses[i]), {"int_affine": float(mses[i])})


def search_weight_params(w, bits: int, device=None) -> SearchResult:
    """Weights ~ normal (paper Fig. 8) -> signed FP with Table 6 spaces."""
    return search_signed_fp(w, bits, device=device)


def search_activation_params(x, bits: int, *, allow_unsigned: bool,
                             with_zero_point: bool = True, device=None
                             ) -> SearchResult:
    """Alg. 1 for one activation site.

    Stage 1 (always): signed FP. Stage 2 (AALs only): unsigned FP (+zp);
    keep whichever minimizes MSE: the 'mixup-sign' selection.
    """
    xs = _subsample(x, device=device)
    res_s = search_signed_fp(xs, bits, maxval_grid=np.linspace(
        0.0, max(float(xs.abs().max()), 1e-8), 100)[1:])
    if not allow_unsigned:
        return res_s
    res_u = search_unsigned_fp(xs, bits, with_zero_point=with_zero_point)
    per_format = {**res_s.per_format, **res_u.per_format}
    if res_u.mse < res_s.mse:
        return SearchResult(res_u.params, res_u.mse, per_format)
    return SearchResult(res_s.params, res_s.mse, per_format)
