"""Device selection: the card by default, the CPU only when asked."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Full-f32 matmuls and convs on the card. cuDNN runs f32 convs in TF32
    by default (about three decimal digits); the reference computes in f32,
    so the plain f32 conv at the io sites, the plain versions and the
    library yardsticks all run inside this."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``cuda`` (the default) requires a card and never falls back to the
    CPU; ``cpu`` is what tests and CPU rehearsals ask for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda is not "
                           "available (pass device='cpu' to run on the CPU)")
    return dev
