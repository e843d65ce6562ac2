"""Hand-written CUDA kernels of the port, one package per kernel: ``ops.py``
(the wrapper: plain version on CPU tensors, kernel on CUDA tensors),
``ref.py`` (the plain version) and ``csrc/`` (the CUDA source).
``_build`` compiles every source into one library at first use."""
