"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Sources live in `csrc/`; `build` compiles and loads them at first
use and counts their launches."""
