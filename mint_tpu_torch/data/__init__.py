"""Training input of the port (counterparts of ``mint_tpu/data``): the
``tf.train.Example`` codec, TFRecord I/O, the host pipeline, the prefetch
onto the device and the device-resident corpus."""
