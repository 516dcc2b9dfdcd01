"""The port's hand-written CUDA kernels (``csrc/``), their build
(``build.py``), their plain PyTorch versions (``ref.py``) and the wrappers
the rest of the package calls (``ops.py``). Importing this package builds
nothing: the first CUDA launch does."""
