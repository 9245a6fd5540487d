"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions (:mod:`repro_torch.kernels.ref`)."""
