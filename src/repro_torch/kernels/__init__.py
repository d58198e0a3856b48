"""The port's kernels: hand-written CUDA C++ for sm_90a (``csrc/``), their
ctypes wrappers, their plain PyTorch versions (``ref``) and the dispatch
layer that chooses between them by the tensors' device."""
