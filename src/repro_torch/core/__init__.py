# The EAGr system in PyTorch: overlay construction and push/pull decisions
# (host numpy, copied from the JAX package), aggregates, windows and the
# leveled execution engine (torch tensors on an explicit device).
