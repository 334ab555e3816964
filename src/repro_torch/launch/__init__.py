"""Launchers of the port: the serving launcher (``serve.py``), the
trainer (``train.py``) and the dry run (``dryrun.py``)."""
