"""rdeic_torch: the PyTorch + CUDA port of rdeic_tpu for NVIDIA Hopper.

Relay-residual diffusion extreme image compression: a VAE feature is coded
to a real bitstream by a checkerboard / channel-slice model and a host rANS
coder, decoded back, and refined by a two-step relay sampler over a dual
UNet; the compression model and the control branch train in the independent
and the refine phase (`rdeic_torch.train`). The kernels that rdeic_tpu wrote
in Pallas are hand-written here for Hopper in CUDA C++; the package
imports nothing of rdeic_tpu or JAX.
"""
