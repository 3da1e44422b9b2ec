"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Each module here binds one `csrc/*.cu` source (built by `_build.py`),
checks its inputs, counts its launches in a module-level integer
`launches`, and sends CPU tensors to the plain version.
"""
