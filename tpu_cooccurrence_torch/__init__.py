"""PyTorch/CUDA port of tpu-cooccurrence: streaming item-item co-occurrence
with LLR scoring, the dense device path on an NVIDIA Hopper card.

The port imports ``torch`` and ``numpy`` and nothing of the JAX package:
it keeps its own copies of the host modules it runs, under the same module
paths, so each counterpart is easy to find. Entry points run on ``cuda``
unless the caller asks for the CPU (see :mod:`.device`).
"""
