"""3x3 "same" convolution (the paper's Conv2D benchmark kernel).

Replaces ``src/repro/kernels/conv2d.py::conv2d`` (Pallas kernel
``_conv_kernel``).  The CUDA kernel (``csrc/conv2d.cu``) computes one
output pixel per thread from its 3x3 neighbourhood with masked halo
loads, so no zero-padded copy of the images is made (the reference pads
in ``ops.conv2d``); the nine taps are summed in the reference's order.
Images are float32, bfloat16 or float16; the output is float32.  It is
bound by bytes.  The plain version is :func:`repro_torch.kernels.ref.
conv2d`, the path for CPU tensors and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Kernel launches made by conv2d; the plain path never counts.
LAUNCHES = 0

_SIGNATURES = {fn: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_void_p]
               for fn in ("conv2d_f32", "conv2d_bf16", "conv2d_f16")}
_ENTRY = {torch.float32: "conv2d_f32", torch.bfloat16: "conv2d_bf16",
          torch.float16: "conv2d_f16"}
_MAX_IMAGES = 65535   # one grid z slice per image

conv2d_plain = ref.conv2d


def conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded "same" convolution of (B, H, W) images with a
    (3, 3) kernel, float32 out.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    global LAUNCHES
    if img.dim() != 3 or tuple(kernel.shape) != (3, 3):
        raise ValueError(f"conv2d needs images (B, H, W) and a (3, 3) "
                         f"kernel, got {tuple(img.shape)} and "
                         f"{tuple(kernel.shape)}")
    if img.device != kernel.device:
        raise ValueError("conv2d operands must share one device")
    if img.device.type == "cpu":
        return conv2d_plain(img, kernel)
    if img.device.type != "cuda":
        raise ValueError(f"conv2d runs on cuda or cpu, not {img.device}")
    if img.dtype not in _ENTRY:
        raise TypeError(f"conv2d takes float32, bfloat16 or float16 "
                        f"images, got {img.dtype}")
    b, h, w = img.shape
    if b > _MAX_IMAGES:
        raise ValueError(f"conv2d takes at most {_MAX_IMAGES} images per "
                         f"call, got {b}")
    img = img.contiguous()
    k = kernel.to(torch.float32).contiguous()
    out = torch.empty((b, h, w), dtype=torch.float32, device=img.device)
    lib = _build.load("conv2d", _SIGNATURES)
    _build.call(lib, "conv2d", getattr(lib, _ENTRY[img.dtype]), img.device,
                img.data_ptr(), k.data_ptr(), out.data_ptr(), b, h, w)
    LAUNCHES += 1
    return out
