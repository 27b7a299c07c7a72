"""Lotaru in PyTorch and CUDA: local profiling traces -> per-task Bayesian
runtime models -> batched posterior predictions -> HEFT placement, with
the fit and the predictive as hand-written kernels for NVIDIA Hopper.

The layout mirrors the JAX package `repro` module for module, so each
counterpart is easy to find.  Entry points take `device` ("cuda" by
default, "cpu" for the plain PyTorch versions of the kernels)."""
