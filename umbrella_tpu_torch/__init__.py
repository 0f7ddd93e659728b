"""PyTorch/CUDA port of umbrella_tpu: static-tree speculative decoding on one GPU.

The package mirrors `umbrella_tpu`'s module paths. Plain tensor code is PyTorch;
every Pallas kernel of the ported path is a hand-written CUDA C++ kernel under
`csrc/`, built with nvcc at first use and bound with ctypes (`ops/kernels/`).
Entry points run on the GPU unless the caller passes `device="cpu"`; on the CPU
each kernel wrapper runs its plain PyTorch version instead.
"""
