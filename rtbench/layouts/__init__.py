"""Column layouts by name: ``rtbench/layouts/<layout>.py``, each a
``build(cfg, seed, cut)`` that returns a ``deployment.Layout``."""
