"""Estimators and models of the port."""
