"""Serving pipelines of the port (SD-family txt2img)."""
