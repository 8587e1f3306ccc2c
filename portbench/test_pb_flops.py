"""The model FLOP count and the kernels' operations and bytes."""
import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, harness, reference


def _cfg(name):
    return json.loads((harness.ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def _meta_weights(cfg):
    w = {}
    for path, shape in reference.flat_shapes(cfg).items():
        t = torch.empty(shape, device="meta")
        if path.endswith("/w") and len(shape) >= 2:
            kind = "io" if path.rsplit("/", 1)[0] in reference.IO_SITES \
                else "q"
            w[path] = (kind, t, torch.empty((), device="meta"))
        else:
            w[path] = t
    return w


@pytest.mark.parametrize("name,gflop,params", [
    ("ddim-cifar10", 12.44, 35_746_307),
    ("ldm4-bedroom", 202.40, 274_056_163)])
def test_model_flops_match_flop_counter_over_the_reference(
        name, gflop, params, monkeypatch):
    cfg = _cfg(name)
    assert sum(math.prod(s) for s in reference.flat_shapes(cfg).values()
               ) == params == cfg["parameters"]
    count = flops.model_flops(cfg, 1)
    assert abs(count / 1e9 - gflop) < 0.005 * gflop
    # FlopCounterMode counts the products; the snaps are elementwise, so
    # the count runs on meta tensors with them left out
    monkeypatch.setattr(reference, "snap_act", lambda x, m: x.float())
    s = cfg["image_size"]
    with FlopCounterMode(display=False) as fc:
        reference.UNet(cfg)(_meta_weights(cfg),
                            torch.empty(1, s, s, cfg["in_ch"], device="meta"),
                            torch.empty(1, device="meta"))
    assert abs(count - fc.get_total_flops()) <= 1e-3 * count


def test_k3_operations_and_bytes_by_hand():
    # ddim-cifar10's first conv1 at batch 8: 3x3, 32x32, 128 -> 128
    conv = next(lay for lay in flops.layers(_cfg("ddim-cifar10"), 8)
                if lay.site == "down_0.res_0/conv1")
    assert conv.kernel == "K3"
    assert conv.flops == 2 * (8 * 32 * 32) * (9 * 128) * 128
    assert conv.bytes == (4 * 8 * 32 * 32 * 128      # f32 acts in
                          + 9 * 128 * 128 // 2 + 4   # packed weight, scale
                          + 4 * 8 * 32 * 32 * 128)   # f32 out
    # the stride-2 downsample reads 32x32 and writes 16x16
    down = next(lay for lay in flops.layers(_cfg("ddim-cifar10"), 2)
                if lay.site == "down_0.downsample")
    assert down.flops == 2 * (2 * 16 * 16) * (9 * 128) * 128
    assert down.bytes == (4 * 2 * 32 * 32 * 128 + 9 * 128 * 128 // 2 + 4
                          + 4 * 2 * 16 * 16 * 128)


def test_k2_operations_and_bytes_by_hand():
    # ldm4-bedroom's mid-block attention q at batch 2: 8x8 tokens, 896 wide
    q = next(lay for lay in flops.layers(_cfg("ldm4-bedroom"), 2)
             if lay.site == "mid.attn/q")
    assert q.kernel == "K2"
    assert q.flops == 2 * 128 * 896 * 896
    assert q.bytes == 4 * 128 * 896 + 896 * 896 // 2 + 4 + 4 * 128 * 896
    t = flops.bound_seconds(q)
    assert t == max(q.flops / 989e12, q.bytes / 3.35e12)
    # the io convs and the attention products are neither kernel's
    kinds = {lay.site: lay.kernel for lay in flops.layers(
        _cfg("ldm4-bedroom"), 1)}
    assert kinds["conv_in"] is None and kinds["conv_out"] is None
    assert kinds["mid.attn"] is None
