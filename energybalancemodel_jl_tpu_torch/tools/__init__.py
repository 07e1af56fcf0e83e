"""Measuring tools of the port: scripts that run on a machine with a CUDA
device and nvcc (``python -m energybalancemodel_jl_tpu_torch.tools.<name>``)."""
