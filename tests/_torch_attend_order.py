"""How far a full-width smollm-135m decode moves on the CPU when only the
order of kv4_attend's f32 sums changes (not a test; ROADMAP Queue C).

    PYTHONPATH=src python tests/_torch_attend_order.py [--smoke]

chip_smoke.py's phase 8 setting (f32, W4A4 on ``steps.dyadic_weights``,
FP4 cache, batch 8, 4 teacher-forced steps) is run twice on the CPU: with
the plain ``kv4_attend`` and with an emulation of a kernel's arithmetic
(the same roundings, each FMA emulated exactly in f64), and the relative
Frobenius error of the logits is printed per step for each order:
  * ``halves-groups``: a logit as two chains over interleaved half rows
    (h = 0, hd/2, 1, hd/2 + 1, ...) added at the end, an output as four
    chains over every fourth slot added in order;
  * ``index``: one chain from zero a result, over h = 0..hd-1 for a logit
    and over s = 0..valid-1 for an output (csrc/kv4.cu:kv4_attend_kernel).
The softmax of the emulation divides by the sum of torch.exp, where the
plain version's vectorised softmax multiplies by the sum's reciprocal.
About a minute at full width.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.smollm_135m import full, smoke
from repro_torch.kernels import kv4
from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                      quantize_lm_for_serving)
from repro_torch.models.lm import init_caches, lm_init
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams


def fma(a, b, c):
    """f32 a * b + c with one rounding: the product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def chains(terms, order):
    """Sum ``terms`` (index -> tensor) in f32 FMA chains: ``order`` is a
    list of chains (lists of indices), each summed from zero, the chains'
    results then added in list order."""
    total = None
    for chain in order:
        acc = 0.0
        for i in chain:
            a, b = terms(i)
            acc = fma(a, b, torch.zeros_like(a) + acc)
        total = acc if total is None else total + acc
    return total


def emulated_attend(kind):
    def attend(q, k, v, k_scale, v_scale, valid_len, scale, softcap=None):
        dt, hd = q.dtype, q.shape[-1]
        hh = hd // 2
        keys = kv4._decode_cache(k, k_scale, dt)[:, :valid_len].float()
        vals = kv4._decode_cache(v, v_scale, dt)[:, :valid_len].float()
        keys, vals = keys.permute(0, 2, 1, 3), vals.permute(0, 2, 1, 3)
        qf = q.float()
        if kind == "index":
            by_h, by_s = [range(hd)], [range(valid_len)]
        else:
            by_h = [[h for j in range(p * hh // 2, (p + 1) * hh // 2)
                     for h in (j, j + hh)] for p in range(2)]
            by_s = [range(g, valid_len, 4) for g in range(4)]
        dot = chains(lambda h: (qf[..., h, None],
                                keys[:, :, None, :, h]), by_h)
        logits = dot * scale
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        w = (e / e.sum(-1, keepdim=True)).to(dt).float()
        o = chains(lambda s: (w[..., s, None], vals[:, :, None, s]), by_s)
        return o.to(dt)
    return attend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    steps, b = 4, 8
    cfg = dataclasses.replace(smoke() if args.smoke else full(),
                              dtype=torch.float32, kv_dtype="fp4")
    toks = torch.randint(0, cfg.vocab, (b, steps),
                         generator=torch.Generator().manual_seed(1))
    packed = quantize_lm_for_serving(dyadic_weights(
        lm_init(torch.Generator().manual_seed(0), cfg)), searched=False)

    def run():
        ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0))})
        step, caches = make_decode_fn(cfg, ctx=ctx), init_caches(
            cfg, b, steps, "cpu")
        out = []
        with torch.inference_mode():
            for i in range(steps):
                lg, caches = step(packed, caches, toks[:, i:i + 1], i)
                out.append(lg)
        return torch.stack(out).double().numpy()

    want, plain = run(), kv4.kv4_attend_plain
    for kind in ("halves-groups", "index"):
        kv4.kv4_attend_plain = emulated_attend(kind)
        try:
            got = run()
        finally:
            kv4.kv4_attend_plain = plain
        per = [float(np.linalg.norm(got[i] - want[i])
                     / np.linalg.norm(want[i])) for i in range(steps)]
        print(f"{cfg.name} f32 dyadic W4A4 FP4-KV B={b}, order {kind}: "
              f"relative Frobenius error per step "
              f"{' '.join(f'{e:.3g}' for e in per)}", flush=True)


if __name__ == "__main__":
    main()
