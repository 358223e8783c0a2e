"""The plain reference path tracer (torch or NumPy only; nothing of the
port, of JAX or of the JAX package)."""
