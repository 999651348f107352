"""The confidential-serving benchmark's harness: traffic, the client loop,
the frozen yardstick, the profiler's reduction and the correctness check.

Nothing here imports JAX or the JAX package; only ``program.py`` imports
the PyTorch port, and only inside the functions that build the system
under test.
"""
