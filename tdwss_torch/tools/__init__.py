"""Diagnostic scripts of the port, run by hand on the card."""
