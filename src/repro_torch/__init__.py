"""PyTorch/CUDA port of the relational LLM serving engine.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage paths (``repro_torch.core.executor`` is the counterpart of
``repro.core.executor``) and imports nothing from it.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
