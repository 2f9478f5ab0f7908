# The serving substrate the JAX package ships beside EAGr, in PyTorch: the
# decoder-only GQA transformer (prefill and decode through the flash-attention
# kernels) and DIEN CTR scoring (its profile lookup through the
# embedding-bag kernel).
