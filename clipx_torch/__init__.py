"""clipx_torch: the PyTorch/CUDA port of clipx for NVIDIA Hopper (H100).

A package of its own beside ``clipx``: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``clipx``. Module layout and names follow
``clipx`` so each module's counterpart is easy to find
(``clipx_torch/models/layers.py`` <-> ``clipx/models/layers.py``). The
TPU Pallas kernels on its path are CUDA C++ kernels under ``csrc/``,
built with ``nvcc`` at first use (``clipx_torch/ops/_build.py``).

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
