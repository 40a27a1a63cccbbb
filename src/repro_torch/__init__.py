"""PyTorch/CUDA port of the IFL system, beside the JAX reference
package ``repro``.

Slice 1 is the serving path: multi-tenant composed-model inference with
continuous batching (``repro_torch.serve``), whose device kernel, flash
decode, is hand-written CUDA C++ for Hopper
(``repro_torch/kernels/csrc/flash_decode.cu``). Slice 2 is the paper's
eager IFL round (``repro_torch.core``, ``repro_torch.api``,
``python -m repro_torch.launch.quickstart``), whose wire encode runs
through ``repro_torch/kernels/csrc/wire_encode.cu``. The package imports
``torch`` and numpy, never JAX and nothing of ``repro``.
"""
