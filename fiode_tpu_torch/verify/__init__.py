"""Certification: the decision-boundary grid, CROWN / IBP bounds, the
interval QP and the ``Certifier``."""
