"""Utilities of the port: test images (``images``), checkpoints
(``checkpoint``), metrics logs (``logging``), NaN checks and trace health
(``debugging``), spot diagrams and lens layouts (``plotting``) and the
wavelength colours they use (``wavelength``)."""
