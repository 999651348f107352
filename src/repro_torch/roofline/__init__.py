"""Roofline terms and model FLOPs of a step, and the tables that render
them (port of ``repro.roofline``)."""
