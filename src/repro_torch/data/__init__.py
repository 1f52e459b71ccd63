"""Synthetic survival data (numpy; same seed, same arrays as the JAX
package's generators)."""
