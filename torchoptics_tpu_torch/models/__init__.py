"""Lens models: topology, parameters, glass, prescriptions."""
