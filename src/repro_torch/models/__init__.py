"""Model code of the port: parameter trees as plain dicts of tensors
with the JAX package's keys and layouts."""
