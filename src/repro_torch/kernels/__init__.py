# Hand-written CUDA kernels for NVIDIA Hopper (sm_90a):
#   segment_agg     sorted-segment reduce (EAGr overlay levels)
#   flash_attention online-softmax GQA attention, prefill and decode (LM serve)
#   embedding_bag   gather + weighted sum per bag (DIEN profile lookup)
# Each package ships csrc/<name>.cu (the kernel, plain C entry points),
# ops.py (the checked wrapper with its launch counts, and plan builders where
# the kernel needs them) and ref.py (the plain PyTorch version, used for CPU
# tensors and as the on-card comparison). Kernels build with nvcc at first
# use (_build.py).
