"""Demos of the port that drive a real failure on the card."""
