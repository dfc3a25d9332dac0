"""The port's copy of what its device modules need from the JAX
package's ``io/`` (GF(256) tables and matrices for erasure coding)."""
