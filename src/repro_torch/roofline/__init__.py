"""Roofline terms of the port on one H100: the card's published peaks and
``roofline_terms`` (``terms.py``), and the dispatch-mode trace that counts
a step's dot FLOPs, dot bytes and peak live bytes (``trace.py``)."""
