"""Evaluation runners of the port."""
