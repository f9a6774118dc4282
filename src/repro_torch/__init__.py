"""PyTorch / CUDA port of the split-learning serving system in ``repro``.

Mirrors the reference package's module layout (``repro/X/y.py`` maps to
``repro_torch/X/y.py``) and imports neither JAX nor anything of ``repro``.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
