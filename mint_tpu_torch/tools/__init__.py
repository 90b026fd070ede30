"""Command-line tools of the port (counterparts of ``mint_tpu/tools``):
``train``, ``evaluate``, ``calculate_scores`` and ``extract_features``."""
