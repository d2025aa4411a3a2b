"""Plain float32 references of what the benchmark's cells compute.

Plain PyTorch, NumPy and SciPy only: no module here imports the program
(``light_unet_tpu_torch``), the JAX package, or anything else of the
repository outside this folder.  Each function works from the inputs the
benchmark made (volumes, weights, corners and generator seeds), never from
what the program derived from them.
"""
