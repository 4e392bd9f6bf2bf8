"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (:mod:`repro_torch.kernels.ref`).  Importing this package builds
nothing."""
