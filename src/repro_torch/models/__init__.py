"""Model substrate of the port: the dense and VLM decoder stacks whose
forward passes the serving engine runs (``transformer.Model``)."""
