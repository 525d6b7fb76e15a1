"""PyTorch / CUDA port of the ``repro`` package.

Mirrors ``repro``'s module layout and names. It imports torch and never
jax, and nothing of ``repro``: the few pure-Python modules it needs are
copied. Entry points default to ``device="cuda"`` and raise when no card
is present; tests pass ``device="cpu"``, where every kernel wrapper takes
its plain PyTorch version.
"""
