"""PyTorch/CUDA port of the repo's JAX package, for NVIDIA Hopper.

Module names mirror the JAX package so each counterpart is easy to find. The
port imports `torch` and never JAX, Flax, Orbax or the JAX package; Pillow is
imported only by `codecs/pil_codecs.py`, at the call that needs it. Entry
points run on `device="cuda"` unless the caller asks for the CPU.
"""
