"""The port's config system: textproto parsing + typed dataclasses.

A copy of ``mint_tpu/config/schema.py`` and ``textproto.py``, so that the
port imports nothing of the JAX package; ``serialize.py`` (config
snapshots for training) is not on the port's path and is not copied.
"""
