"""Layers of the port: params are plain dicts of tensors."""
