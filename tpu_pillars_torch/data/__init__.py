"""Seeded synthetic training data (numpy only)."""
