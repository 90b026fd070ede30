"""The port's config system: textproto parsing + typed dataclasses.

A copy of ``mint_tpu/config/schema.py``, ``textproto.py`` and
``serialize.py`` (the train CLI's config snapshot), so that the port
imports nothing of the JAX package.
"""
