"""Scenario batching helpers."""
