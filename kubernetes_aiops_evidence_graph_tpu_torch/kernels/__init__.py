"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources build at first launch (see ``_build.py``); importing this
package builds and loads nothing."""
