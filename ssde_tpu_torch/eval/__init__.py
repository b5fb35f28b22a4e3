"""Evaluation of the port: the GRU runners and the depth protocol."""
