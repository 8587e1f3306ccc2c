"""LM serving launcher: batched greedy decode with optional W4 weights, W4A4
act quant and an FP8/FP4 KV cache; port of ``repro.launch.serve``.

Random weights from ``--seed`` (no weights are downloaded), quantized to
packed W4, a prompt batch prefilled by stepping it through the decode
step, then ``--gen-len`` greedy tokens. Runs on the card unless
``--device cpu`` is given.

    python -m repro_torch.launch.serve --arch smollm-135m --quant w4 \\
        --act-quant fp4 --kv fp4 --batch 8 --prompt-len 32 --gen-len 32

Besides the reference's report lines it prints the dispatch routes
(``ops.ROUTES``) and the kernel launches per decode step.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.common.clock import wall_clock
from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import kv4, ops, w4_matmul
from repro_torch.launch.steps import make_decode_fn, quantize_lm_for_serving
from repro_torch.models.lm import init_caches, lm_init
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams

KERNELS = {"w4a4_matmul": w4_matmul.w4_matmul_2d_cuda,
           "kv4_store": kv4.kv4_store_cuda,
           "kv4_attend": kv4.kv4_attend_cuda,
           "kv4_encode": kv4.kv4_encode_2d_cuda,
           "kv4_decode": kv4.kv4_decode_2d_cuda}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--quant", default="bf16", choices=["bf16", "w4", "w4pc"],
                    help="w4 = per-tensor scales; w4pc = per-output-channel")
    ap.add_argument("--kv", default="bf16", choices=["bf16", "fp8", "fp4"])
    ap.add_argument("--act-quant", default="off", choices=["off", "fp4"],
                    help="fp4 = fuse E2M1 activation quant into the W4 "
                         "matmul kernel (W4A4 serving)")
    ap.add_argument("--act-maxval", type=float, default=6.0,
                    help="per-tensor activation grid max for --act-quant")
    ap.add_argument("--greedy", action="store_true", default=True,
                    help="kept to match the reference's flags; decode is "
                         "always greedy")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _launches() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              kv_dtype=args.kv)
    s_max = args.prompt_len + args.gen_len
    gen = torch.Generator().manual_seed(args.seed)

    params = lm_init(gen, cfg, device)
    if args.quant in ("w4", "w4pc"):
        t0 = wall_clock()
        params = quantize_lm_for_serving(params, searched=False,
                                         per_channel=(args.quant == "w4pc"))
        _sync(device)
        print(f"quantized to W4 ({args.quant}) in "
              f"{wall_clock() - t0:.1f}s")
    ctx = None
    if args.act_quant == "fp4" and args.quant == "bf16":
        print("note: --act-quant fp4 with --quant bf16 quantizes activations "
              "in a standalone msfp pass (A4 only; no packed weights to fuse "
              "into)")
    if args.act_quant == "fp4":
        qp = QuantizerParams(KIND_FP_SIGNED, 2, 1, 4,
                             torch.tensor(args.act_maxval, device=device))
        ctx = QuantContext("serve", act_qps={"*": qp})
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(device)
    caches = init_caches(cfg, args.batch, s_max, device)
    dec = make_decode_fn(cfg, ctx=ctx)

    with torch.inference_mode():
        # prefill by stepping the prompt (teacher-forced decode fills caches)
        _sync(device)
        t0 = wall_clock()
        logits = None
        for i in range(args.prompt_len):
            logits, caches = dec(params, caches, prompts[:, i:i + 1], i)
        _sync(device)
        prefill_s = wall_clock() - t0

        out_tokens = []
        before = _launches()
        t0 = wall_clock()
        tok = logits[:, -1:].argmax(-1)
        for i in range(args.gen_len):
            out_tokens.append(tok[:, 0])
            logits, caches = dec(params, caches, tok, args.prompt_len + i)
            tok = logits[:, -1:].argmax(-1)
        _sync(device)
        decode_s = wall_clock() - t0
    per_step = {k: (n - before[k]) / max(args.gen_len, 1)
                for k, n in _launches().items()}
    gen_ids = torch.stack(out_tokens, dim=1).cpu()
    if not bool(torch.isfinite(logits.float()).all()):
        raise FloatingPointError("non-finite logits after decode")
    tok_s = args.gen_len * args.batch / max(decode_s, 1e-9)
    print(f"arch={cfg.name} quant={args.quant} act={args.act_quant} "
          f"kv={args.kv} device={device}")
    print(f"prefill: {prefill_s:.2f}s  decode: {decode_s:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print("sample ids:", gen_ids[0][:16].tolist())
    routes = ", ".join(f"{op}/{route}={n}"
                       for (op, route), n in sorted(ops.ROUTES.items()))
    print(f"routes: {routes}")
    print("kernel launches per decode step: "
          + ", ".join(f"{k}={v:g}" for k, v in per_step.items()))
    return {"prefill_s": prefill_s, "decode_s": decode_s, "tok_s": tok_s,
            "tokens": gen_ids, "logits": logits, "launches_per_step": per_step,
            "steps": args.prompt_len + args.gen_len}


if __name__ == "__main__":
    main()
