"""OPA-DPO in PyTorch for NVIDIA Hopper (H100).

A port of the JAX/TPU package ``opadpo_tpu``, which stays beside it as the
numerical reference.  This package imports ``torch`` and numpy, never JAX
and never ``opadpo_tpu``.  Its hot kernels are CUDA C++ written for
``sm_90a`` (``csrc/``), built with ``nvcc`` on first use
(``ops/_build.py``); each keeps a plain PyTorch version beside it that runs
only for tensors on the CPU.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from opadpo_torch.device import resolve_device

__all__ = ["resolve_device"]
