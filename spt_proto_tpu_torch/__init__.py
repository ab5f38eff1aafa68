"""PyTorch/CUDA port of spt_proto_tpu for one NVIDIA H100.

The JAX package spt_proto_tpu stays beside this one as the reference; this
package imports torch and never jax or spt_proto_tpu. Module names follow the
JAX package so each module's counterpart is easy to find. The TPU package's
Pallas kernels become hand-written CUDA kernels under csrc/ (built by
_build.py at first use); every kernel wrapper runs its plain PyTorch twin for
CPU tensors and launches the kernel for CUDA tensors.
"""
