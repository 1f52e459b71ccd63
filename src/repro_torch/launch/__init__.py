"""Launchers: the runtime policy, the data-parallel group and the train
entry point (the PyTorch port's counterpart of the JAX package's
``launch/``)."""
