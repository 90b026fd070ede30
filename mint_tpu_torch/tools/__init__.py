"""Command-line tools of the port (counterparts of ``mint_tpu/tools``):
``train``, ``evaluate``, ``calculate_scores``, ``extract_features``,
``preprocessing`` (AIST++ music and motion -> tfrecords, with the audio
feature cache), ``bvh_export`` (motion -> BVH) and ``visualize`` (motion ->
skeleton GIF or PNG frames)."""
