"""Launchers of the model stack: step functions and the serving loop."""
