"""Decoder-only LM of the port: layers and the dense transformer."""
