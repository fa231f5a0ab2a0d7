"""wrenc-tpu-torch: the PyTorch/CUDA port of the wrenc-tpu all-intra
H.266/VVC encoder, for NVIDIA Hopper.

Mirrors `wrenc_tpu`'s layout module for module. Numpy-only layers (spec
model, tables, entropy, bitstream, decoder) are copies; the device path
(luma stage A) is PyTorch, and the two sequential dependent-quantization
scans are hand-written CUDA kernels (kernels/csrc/dq_scan.cu) with plain
PyTorch twins that CPU tensors take. Entry points run on the card unless
the caller asks for the CPU.

Every matmul in the port is an exact integer product carried in f32, so
TF32 must never be used: it is switched off here, at import, and the one
exact-matmul helper (kernels/transforms.f32mm) asserts it before every
product on CUDA.
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
