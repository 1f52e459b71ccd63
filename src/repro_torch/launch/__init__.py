"""Launchers: the runtime policy, the data-parallel group and the train
and serve entry points (the PyTorch port's counterpart of the JAX
package's ``launch/``)."""
