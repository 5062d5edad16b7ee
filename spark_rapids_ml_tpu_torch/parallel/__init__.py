"""Partition tasks and their reduction."""
