"""PyTorch/CUDA port of the confidential LLM inference system in ``repro``.

The JAX package ``repro`` is the reference and stays unchanged; this package
grows beside it slice by slice (ROADMAP.md). It imports torch, numpy and the
standard library only. Entry points (``runtime.Engine``, ``models.Model``,
``launch/serve.py``) run on the CUDA card unless the caller passes
``device="cpu"``.
"""
