"""Launchers of the port: the serving launcher (``serve.py``) and the
trainer (``train.py``)."""
