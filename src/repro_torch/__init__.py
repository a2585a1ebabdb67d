"""DeepStream in PyTorch with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``: same layout and names, held
against it on the same inputs.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
