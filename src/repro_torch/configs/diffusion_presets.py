"""The paper's own model configs (DDIM / LDM UNets) + reduced variants;
port of ``repro.configs.diffusion_presets``."""
from repro_torch.nn.unet import UNetConfig


def ddim_cifar10() -> UNetConfig:
    return UNetConfig(image_size=32, ch=128, ch_mult=(1, 2, 2, 2),
                      num_res_blocks=2, attn_resolutions=(16,))


def ddim_celeba() -> UNetConfig:
    return UNetConfig(image_size=64, ch=128, ch_mult=(1, 2, 2, 2, 4),
                      num_res_blocks=2, attn_resolutions=(16,))


def ldm4_bedroom() -> UNetConfig:
    # LDM-4: 256x256 images -> 64x64x3 latents
    return UNetConfig(image_size=64, in_ch=3, out_ch=3, ch=224,
                      ch_mult=(1, 2, 3, 4), num_res_blocks=2,
                      attn_resolutions=(32, 16, 8))


def ldm8_church() -> UNetConfig:
    # LDM-8: 256x256 -> 32x32x4 latents
    return UNetConfig(image_size=32, in_ch=4, out_ch=4, ch=192,
                      ch_mult=(1, 2, 2, 4), num_res_blocks=2,
                      attn_resolutions=(16, 8))


def ldm4_imagenet() -> UNetConfig:
    return UNetConfig(image_size=64, in_ch=3, out_ch=3, ch=192,
                      ch_mult=(1, 2, 3, 5), num_res_blocks=2,
                      attn_resolutions=(32, 16, 8), num_classes=1000)


def tiny_ddim(size: int = 16) -> UNetConfig:
    """CPU-sized reduced config used by tests."""
    return UNetConfig(image_size=size, ch=32, ch_mult=(1, 2),
                      num_res_blocks=1, attn_resolutions=(size // 2,),
                      gn_groups=8)


DIFFUSION_PRESETS = {
    "ddim-cifar10": ddim_cifar10,
    "ddim-celeba": ddim_celeba,
    "ldm4-bedroom": ldm4_bedroom,
    "ldm8-church": ldm8_church,
    "ldm4-imagenet": ldm4_imagenet,
    "tiny-ddim": tiny_ddim,
}
