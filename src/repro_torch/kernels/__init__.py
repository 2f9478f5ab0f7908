# Hand-written CUDA kernels for NVIDIA Hopper (sm_90a):
#   segment_agg     sorted-segment reduce (EAGr overlay levels)
# Each package ships csrc/<name>.cu (the kernel, plain C entry points),
# ops.py (plan builders + the checked wrapper with its launch counts) and
# ref.py (the plain PyTorch version, used for CPU tensors and as the
# on-card comparison). Kernels build with nvcc at first use (_build.py).
