"""The port's device kernels: hand-written CUDA C++ for Hopper in
``csrc/``, built by ``build.py``, dispatched by ``ops.py``, each with
its plain PyTorch version in ``ref.py``."""
