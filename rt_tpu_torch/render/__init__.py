"""Integrator, renderer and film."""
