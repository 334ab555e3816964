"""Launchers of the port: the serving launcher (``serve.py``)."""
