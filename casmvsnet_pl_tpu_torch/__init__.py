"""CasMVSNet in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``casmvsnet_pl_tpu`` (JAX on a TPU), which stays the reference
that this package is tested against. Module names mirror the JAX package.
This package imports neither JAX nor the JAX package.
"""
