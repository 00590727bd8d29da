"""The benchmark's harness: cell discovery, inputs, drivers, trace reduction,
the yardstick and the check of ``correct``.  Nothing here imports JAX or the
JAX package; the program is imported only by ``drivers``."""
