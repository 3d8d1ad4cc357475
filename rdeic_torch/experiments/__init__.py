"""The evaluation harnesses (counterparts of the root experiments/): OOD
domains, robustness to corrupted streams and latents, qualitative grids,
and the fault injectors they use."""
