"""Profiling and timing (utils/profiling.py)."""
