"""Roofline terms of a traced step on the H100: ``analysis`` (the terms, the
peaks, ``model_flops``) and ``trace`` (the counter a step runs under)."""
from .analysis import HW, RooflineTerms, collective_bytes, model_flops, roofline_terms
from .trace import StepCounter

__all__ = ["HW", "RooflineTerms", "collective_bytes", "roofline_terms", "model_flops",
           "StepCounter"]
