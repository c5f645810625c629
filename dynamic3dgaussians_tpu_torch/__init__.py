"""PyTorch + CUDA (Hopper) port of dynamic3dgaussians_tpu.

The JAX package `dynamic3dgaussians_tpu` is the reference; this package
imports `torch`, numpy and scipy, never `jax` and nothing of the JAX
package.
Its module tree mirrors the reference where a module has a counterpart
(`ops/projection.py` <-> `ops/projection.py`, ...). Every TPU kernel on a
ported path is a hand-written Hopper kernel under `csrc/`, bound with ctypes
(`_build.py`), next to a plain PyTorch version of the same function.

Entry points run on `cuda` unless the caller passes `device=...`; without
CUDA and without an explicit device they raise (see `device.resolve_device`).

Ported so far: the forward render of a trained scene (`cli visualize`)
and the first timestep of training (`cli train` with one timestep: the
render's gradient through the backward kernel, losses, Adam,
densification, compaction, the kNN graph and the RCM reorder).
"""
