"""moby_tpu_torch: the PyTorch/CUDA port of moby_tpu.

Same layout and function names as the JAX package ``moby_tpu`` so that the
counterpart of a module is found by its path. The batch dimension is written
out: every ``State`` field and every function of the contact step takes a
leading ``B``; ``Scene`` tables are shared by the batch.

Importing this package touches neither CUDA nor any compiled kernel: the
hand-written kernel under ``csrc/`` is built and loaded the first time its
wrapper meets a CUDA tensor.
"""
