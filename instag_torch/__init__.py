"""instag_torch: the PyTorch/CUDA port of instag_tpu for NVIDIA Hopper.

Module names mirror ``instag_tpu`` so each module's counterpart is easy to
find. The package imports ``torch`` and never JAX. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; without
a card a CUDA device raises instead of falling back to the CPU.
"""

__version__ = "0.1.0"
