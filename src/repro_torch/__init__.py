"""repro_torch — AWAPart's adaptive workload-aware partitioning service on
PyTorch, with its kernels hand-written in CUDA for NVIDIA Hopper.

``repro_torch.X`` mirrors ``repro.X`` module for module. The serving loop
(``repro_torch.api.KGService``) runs on the card by default
(``device="cuda"``): hash joins go through the pack/probe/expand/gather
kernels and every adaptation round's Jaccard matrix through the Jaccard
kernel (``repro_torch/csrc/``, built with ``nvcc`` at first use).
``device="cpu"`` runs the same loop through each kernel's plain PyTorch
version. The language models serve and train on the card as well
(``repro_torch.models.lm``, ``repro_torch.launch.train``).
``repro_torch.interop`` builds the port's objects from plain numpy state.
"""
