"""The sequence pipelines of NeuralRecon's configs (``compose``,
``transforms_seq``); importing this package registers them in
``PIPELINES``.  The JAX package's single-image pipelines are not ported."""
from . import compose, transforms_seq  # noqa: F401
