"""Device layer: limb-tensor field and group arithmetic, MSM, CUDA kernels."""
