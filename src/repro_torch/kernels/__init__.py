"""Hand-written Hopper kernels of the serving path, their plain PyTorch
versions, and the backend dispatch."""
