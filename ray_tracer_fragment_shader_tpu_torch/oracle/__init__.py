"""The float64 numpy oracle (the port's own copy of the JAX package's
``oracle/``: no JAX, so it runs on the card's machine) and the gradient-bar
harness built on it."""
from .numpy_ref import OracleScene, oracle_pixels, oracle_render, trace_ray

__all__ = ["OracleScene", "oracle_pixels", "oracle_render", "trace_ray"]
