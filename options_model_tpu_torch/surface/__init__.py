"""Volatility surfaces: the Chebyshev local-vol table (cheb.py)."""
