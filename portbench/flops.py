"""Operations and bytes from the layer shapes, and the table of peaks.

``layers(cfg, batch)`` (the UNet family's, ``families/unet.py``) walks
the UNet as the configuration defines it and lists every product the
model computes: each conv and dense layer and the two attention
products. The model's FLOPs are twice the multiply-adds of
those products (what ``torch.utils.flop_counter.FlopCounterMode`` counts);
a kernel's bound counts the operations of the layers it computes and the
bytes of reading each input once and writing each output once, at the rows
it processed. Neither depends on how a layer is implemented.
"""
from __future__ import annotations

import dataclasses

# One NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core peak and HBM3.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

F32 = 4


@dataclasses.dataclass(frozen=True)
class Layer:
    site: str
    kind: str        # "conv" (k x k, stride), "dense", "attn" (two products)
    m: int           # output rows: batch x output pixels (conv, attn: batch)
    k: int           # reduction: k*k*cin (conv), din (dense), c (attn)
    n: int           # output columns: cout, dout; attn: tokens
    io: bool = False  # the io convs (dense bf16 weight, qdq_conv2d)
    in_rows: int = 0  # input pixels x batch (conv)
    cin: int = 0

    @property
    def flops(self) -> int:
        if self.kind == "attn":   # q k^T and p v: each tokens^2 x c MACs
            return 2 * 2 * self.m * self.n * self.n * self.k
        return 2 * self.m * self.k * self.n

    @property
    def kernel(self) -> str | None:
        """Which kernel computes it: K3 (packed conv), K2 (packed dense)."""
        if self.io or self.kind == "attn":
            return None
        return "K3" if self.kind == "conv" else "K2"

    @property
    def bytes(self) -> int:
        """f32 acts in and out once, the 4-bit packed weight and its scale."""
        w = self.k * self.n // 2 + F32
        if self.kind == "conv":
            return F32 * self.in_rows * self.cin + w + F32 * self.m * self.n
        return F32 * self.m * self.k + w + F32 * self.m * self.n


def layers(cfg: dict, batch: int) -> list[Layer]:
    ch, temb = cfg["ch"], 4 * cfg["ch"]
    out: list[Layer] = []

    def conv(site, res, cin, cout, k=3, stride=1, io=False):
        o = -(-res // stride)
        out.append(Layer(site, "conv", batch * o * o, k * k * cin, cout, io,
                         batch * res * res, cin))

    def dense(site, rows, din, dout):
        out.append(Layer(site, "dense", rows, din, dout))

    def res_block(site, res, cin, cout):
        conv(f"{site}/conv1", res, cin, cout)
        dense(f"{site}/temb", batch, temb, cout)
        conv(f"{site}/conv2", res, cout, cout)
        if cin != cout:
            conv(f"{site}/skip", res, cin, cout, k=1)

    def attn(site, res, c):
        rows = batch * res * res
        for n in ("q", "k", "v"):
            dense(f"{site}/{n}", rows, c, c)
        out.append(Layer(site, "attn", batch, c, res * res))
        dense(f"{site}/proj", rows, c, c)

    dense("temb0", batch, ch, temb)
    dense("temb1", batch, temb, temb)
    res = cfg["image_size"]
    conv("conv_in", res, cfg["in_ch"], ch, io=True)
    chans, c_cur, mults = [ch], ch, cfg["ch_mult"]
    for i, mult in enumerate(mults):
        for j in range(cfg["num_res_blocks"]):
            res_block(f"down_{i}.res_{j}", res, c_cur, ch * mult)
            c_cur = ch * mult
            if res in cfg["attn_resolutions"]:
                attn(f"down_{i}.attn_{j}", res, c_cur)
            chans.append(c_cur)
        if i != len(mults) - 1:
            conv(f"down_{i}.downsample", res, c_cur, c_cur, stride=2)
            res //= 2
            chans.append(c_cur)
    res_block("mid.res_0", res, c_cur, c_cur)
    attn("mid.attn", res, c_cur)
    res_block("mid.res_1", res, c_cur, c_cur)
    for i in reversed(range(len(mults))):
        for j in range(cfg["num_res_blocks"] + 1):
            res_block(f"up_{i}.res_{j}", res, c_cur + chans.pop(),
                      ch * mults[i])
            c_cur = ch * mults[i]
            if res in cfg["attn_resolutions"]:
                attn(f"up_{i}.attn_{j}", res, c_cur)
        if i != 0:
            res *= 2
            conv(f"up_{i}.upsample", res, c_cur, c_cur)
    conv("conv_out", res, c_cur, cfg["out_ch"], io=True)
    return out


def model_flops(cfg: dict, batch: int = 1) -> int:
    return sum(layer.flops for layer in layers(cfg, batch))


def bound_seconds(layer: Layer) -> float:
    """The least time the chip could take: operations or bytes at peak."""
    return max(layer.flops / PEAK_FLOPS, layer.bytes / PEAK_BYTES)


def kernel_bound_seconds(cfg: dict, kernel: str, batch: int) -> float:
    """Sum of the bounds of one forward's launches of ``kernel`` at
    ``batch`` rows (padding included)."""
    return sum(bound_seconds(layer) for layer in layers(cfg, batch)
               if layer.kernel == kernel)
