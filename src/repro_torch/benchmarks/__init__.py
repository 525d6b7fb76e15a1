"""The paper's measurement surfaces on the port: Figs 2, 3 and 4 and the
``run.py`` that runs them all, each a module run with ``python -m``."""
