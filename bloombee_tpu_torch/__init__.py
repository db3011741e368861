"""PyTorch/CUDA port of bloombee_tpu's span-serving device path.

The package mirrors `bloombee_tpu`'s layout module for module, so each
counterpart sits at the same relative path. It imports torch, numpy and the
standard library only: never jax, and never a module of `bloombee_tpu`
(what it needs from a jax-free module there is copied here).

The three attention kernels on the serving path are hand-written CUDA C++
for Hopper (`ops/cuda/csrc/`), each beside a plain PyTorch version of the
same function. A wrapper runs its plain version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises.

Entry points (`SpanExecutor`, `CacheManager`, parameter init/load) default
to `device="cuda"` and raise without a GPU unless the caller passes
`device="cpu"`.
"""
