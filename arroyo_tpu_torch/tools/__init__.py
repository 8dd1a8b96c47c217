"""Measurement scripts of the port that the package does not run."""
