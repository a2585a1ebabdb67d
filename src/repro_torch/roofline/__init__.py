"""The analytic roofline (``analytic.py``) and the model FLOP count
(``analysis.py``): the counterparts of ``repro.roofline``'s pure
arithmetic, with the card's constants in ``common.config.H100_SXM``."""
