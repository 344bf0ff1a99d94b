"""Configs, payoffs and Monte-Carlo statistics."""
