"""Solvers and experiments built on the ops layer."""
