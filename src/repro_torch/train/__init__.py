"""Training: the AdamW optimizer, the train step, the loop, checkpoints,
gradient compression and fault tolerance (the PyTorch port's counterpart
of the JAX package's ``train/``)."""
