"""Analytic performance models of the port."""
