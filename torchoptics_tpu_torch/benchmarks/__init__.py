"""Probes and measurements of the port that run on the card."""
