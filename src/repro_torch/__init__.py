"""FILCO reproduction, PyTorch/CUDA port for one NVIDIA H100.

A second package beside the JAX reference ``repro``: it mirrors that
package's layout, imports nothing from it, and holds each ported module to
its reference in ``tests/test_torch_*.py``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
