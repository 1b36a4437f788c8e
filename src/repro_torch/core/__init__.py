"""HFL core on PyTorch: feature tensors, networks, policies, primitives,
the sequential federation engine and the experiment entry points."""
