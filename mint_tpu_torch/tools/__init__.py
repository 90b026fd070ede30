"""Command-line tools of the port (counterparts of ``mint_tpu/tools``):
``train``."""
