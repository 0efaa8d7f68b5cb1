"""PyTorch + CUDA port of the ``repro`` PANN serving system for one NVIDIA
H100 (sm_90a).

Each module keeps the relative path of the JAX module it ports, so every
file names its reference. The package imports torch, numpy and the
standard library only — never ``jax`` and nothing of ``repro`` — and its
entry points run on the card unless the caller passes ``device="cpu"``.
"""
