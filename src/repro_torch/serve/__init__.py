"""LM serving on the port (port of ``repro/serve``): the continuous-batching
``ServeEngine``."""
